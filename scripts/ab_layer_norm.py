"""Time K1 from an earlier tree beside this tree's, on one card, on the same inputs.

    python3 scripts/ab_layer_norm.py EARLIER_DIR

EARLIER_DIR holds the ``vlfm_tpu_torch/`` of an earlier tree (for the
parent commit, ``git archive 0d5a967 vlfm_tpu_torch | tar -x -C DIR``:
four rows a block, scale and bias loaded after the reductions, no fused
entry). The script compiles that tree's
``vlfm_tpu_torch/csrc/layer_norm.cu`` alone (nvcc, sm_90a) into
``EARLIER_DIR/build_ab/`` and loads it with ctypes under the C signatures
this tree declares. Then, with the seed and the CUDA-event medians of 50
calls of ``chip_smoke.py``'s phase 2, it times the earlier kernel and this
tree's in turns (earlier, this tree, this tree, earlier):

- the plain entry at every shape of ``LN_CASES`` and ``ADD_LN_CASES``;
- the fused entry at every ``ADD_LN_CASES`` shape, where the earlier tree
  has one (``vlfm_add_layer_norm``).

Both outputs are held to the plain version (one bf16 ulp) and to each
other bit for bit wherever the earlier body shares this one's arithmetic
(the 16-byte path; on the ragged path, D = 33, the parent's build had
contracted the mean into the centring); the line says whether they are.

Last, the host's cost of one call at the B=1 act's ViT-g shape (257, 1408)
bf16, as ``chip_smoke.py`` measures it (wall per call over 200
back-to-back calls): the earlier tree's Python wrappers
(``EARLIER_DIR/vlfm_tpu_torch/ops/norms.py``, loaded as a module of its
own, calling this tree's library) against this tree's, in turns.

It prints one line per case and, last, a JSON object: "plain rows x D
dtype" and "fused rows x D dtype keep_sum=... (site)" -> {"earlier_ms",
"ms"}, each the mean of its two turns, and "host <entry>" ->
{"earlier_us", "us"}. Needs one card.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as S  # noqa: E402
from vlfm_tpu_torch.kernels import build  # noqa: E402
from vlfm_tpu_torch.ops import norms as N  # noqa: E402


def earlier_kernels(earlier: Path) -> dict:
    """The earlier body's entries, built from its own source: "plain" and,
    where the tree has it, "fused", each with its wrapper's Python
    signature."""
    out = earlier / "build_ab"
    out.mkdir(exist_ok=True)
    lib_path = out / "liblayer_norm_earlier.so"
    src = earlier / "vlfm_tpu_torch" / "csrc" / "layer_norm.cu"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    mine = build.load_library()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    lib.vlfm_layer_norm.argtypes = mine.vlfm_layer_norm.argtypes
    lib.vlfm_layer_norm.restype = ctypes.c_int

    def plain(x, scale, bias, eps):
        y = torch.empty_like(x)
        d = x.shape[-1]
        err = lib.vlfm_layer_norm(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), x.numel() // d,
                                  d, float(eps), N._DTYPE_CODES[x.dtype], stream())
        if err:
            raise RuntimeError(f"the earlier plain entry failed: cudaError {err}")
        return y

    kernels = dict(plain=plain)
    if hasattr(lib, "vlfm_add_layer_norm"):
        lib.vlfm_add_layer_norm.argtypes = mine.vlfm_add_layer_norm.argtypes
        lib.vlfm_add_layer_norm.restype = ctypes.c_int

        def fused(x, h, scale, bias, eps, *, keep_sum):
            y = torch.empty_like(x)
            s = torch.empty_like(x) if keep_sum else None
            d = x.shape[-1]
            err = lib.vlfm_add_layer_norm(
                x.data_ptr(), h.data_ptr(), h.numel() // d, scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                None if s is None else s.data_ptr(), x.numel() // d, d, float(eps), N._DTYPE_CODES[x.dtype],
                stream())
            if err:
                raise RuntimeError(f"the earlier fused entry failed: cudaError {err}")
            return (s, y) if keep_sum else y

        kernels["fused"] = fused
    return kernels


def earlier_wrappers(earlier: Path):
    """The earlier tree's ``ops/norms.py`` as a module of its own."""
    spec = importlib.util.spec_from_file_location("earlier_norms", earlier / "vlfm_tpu_torch" / "ops" / "norms.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def turns(earlier_fn, fn, timer) -> tuple[list[float], float, float]:
    """earlier, this tree, this tree, earlier; the two means."""
    t = [timer(f) for f in (earlier_fn, fn, fn, earlier_fn)]
    return t, (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def main() -> None:
    if len(sys.argv) != 2 or not os.path.isdir(sys.argv[1]):
        raise SystemExit(__doc__)
    earlier_dir = Path(sys.argv[1]).resolve()
    smi = S.phase_device()
    S.phase_build()
    old = earlier_kernels(earlier_dir)
    gen = torch.Generator(device=S.DEV).manual_seed(0)
    shapes = [(rows, d, dt, eps) for rows, d, dt, eps in S.LN_CASES]
    shapes += [(rows, d, dt, eps) for _, rows, _, d, dt, eps, _ in S.ADD_LN_CASES
               if (rows, d, dt, eps) not in shapes]
    result = {}
    for rows, d, dt, eps in shapes:
        x, scale, bias = S.ln_inputs(rows, d, dt, gen)
        want = N.layer_norm_ref(x, scale, bias, eps)
        outs = [f(x, scale, bias, eps) for f in (old["plain"], N.layer_norm)]
        errs = [S.ln_error(o, want) for o in outs]
        S.check(all(ok for _, ok, _ in errs), f"{rows}x{d}: {errs} against the plain version")
        same = bool(torch.equal(outs[0], outs[1]))
        S.check(same or d % (16 // x.element_size()) != 0, f"{rows}x{d}: the two bodies differ")
        t, t_old, t_new = turns(lambda: old["plain"](x, scale, bias, eps), lambda: N.layer_norm(x, scale, bias, eps),
                                S._median_ms)
        name = f"plain {rows}x{d} {str(dt).split('.')[-1]}"
        result[name] = dict(earlier_ms=t_old, ms=t_new)
        S.log(f"[ab] {name} eps={eps:g}: earlier {t[0]:.4f} / {t[3]:.4f} ms, this tree {t[1]:.4f} / {t[2]:.4f} ms; "
              f"outputs bit-equal {same}, max error {errs[1][0]:.3e}; on {smi}")
    if "fused" in old:
        for site, rows, h_rows, d, dt, eps, keep in S.ADD_LN_CASES:
            x, scale, bias = S.ln_inputs(rows, d, dt, gen)
            x = x.reshape(rows // h_rows, h_rows, d)
            h = (torch.randn(h_rows, d, generator=gen, device=S.DEV) * 3.0 + 1.0).to(dt)
            outs = [f(x, h, scale, bias, eps, keep_sum=True) for f in (old["fused"], N.add_layer_norm)]
            S.check(all(torch.equal(a, b) for a, b in zip(*outs)), f"{site}: the two fused entries differ")
            t, t_old, t_new = turns(lambda: old["fused"](x, h, scale, bias, eps, keep_sum=keep),
                                    lambda: N.add_layer_norm(x, h, scale, bias, eps, keep_sum=keep), S._median_ms)
            name = f"fused {rows}x{d} {str(dt).split('.')[-1]} keep_sum={keep} ({site})"
            result[name] = dict(earlier_ms=t_old, ms=t_new)
            S.log(f"[ab] {name}: earlier {t[0]:.4f} / {t[3]:.4f} ms, this tree {t[1]:.4f} / {t[2]:.4f} ms; "
                  f"outputs bit-equal True; on {smi}")

    old_py = earlier_wrappers(earlier_dir)
    x, scale, bias = S.ln_inputs(257, 1408, torch.bfloat16, gen)
    h = torch.randn_like(x)
    forms = dict(plain=(lambda m: lambda: m.layer_norm(x, scale, bias, 1e-6)))
    if hasattr(old_py, "add_layer_norm"):
        forms["fused"] = lambda m: lambda: m.add_layer_norm(x, h, scale, bias, 1e-6, keep_sum=True)
    for entry, form in forms.items():
        t, t_old, t_new = turns(form(old_py), form(N), S.host_us)
        result[f"host {entry}"] = dict(earlier_us=t_old, us=t_new)
        S.log(f"[ab] host cost of the {entry} wrapper at (257, 1408) bf16 (wall per call over {S.HOST_CALLS} "
              f"back-to-back calls): earlier {t[0]:.2f} / {t[3]:.2f} us, this tree {t[1]:.2f} / {t[2]:.2f} us; "
              f"on {smi}")
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
