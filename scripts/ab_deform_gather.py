"""Time K4's earlier design beside this tree's, on one card, on the same inputs.

    python3 scripts/ab_deform_gather.py PARENT_DIR

PARENT_DIR holds a checkout of the earlier commit (``git archive 717047f``:
one warp per (b, q, h), no launch plan). The script compiles that
checkout's ``vlfm_tpu_torch/csrc/deform_gather.cu`` alone (nvcc, sm_90a)
into ``PARENT_DIR/build_ab/``, loads it with ctypes under that design's C
signature, and for every case of ``chip_smoke.py`` phase 13 (its inputs,
its seed, its CUDA-event medians of 50 calls) times the earlier kernel and
this tree's in turns: earlier, this tree, this tree, earlier. Both outputs
are held to the plain version with ``deform_gather_tolerance``. It prints
one line per case and, last, a JSON object: case -> {"parent_ms",
"ms", "plan"}, each time the mean of its two turns. Needs one card.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as S  # noqa: E402
from vlfm_tpu_torch.kernels import build  # noqa: E402
from vlfm_tpu_torch.ops import deform_gather as DG  # noqa: E402


def parent_kernel(parent: Path):
    """The earlier design's C entry point, built from its own source."""
    out = parent / "build_ab"
    out.mkdir(exist_ok=True)
    lib = out / "libdeform_parent.so"
    src = parent / "vlfm_tpu_torch" / "csrc" / "deform_gather.cu"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).vlfm_deform_gather
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, ctypes.POINTER(i), i, i, i, i, i, i, i, i, i, p]
    fn.restype = i

    def run(value, levels, grids, weights):
        b, q, nh, nl, npts, _ = grids.shape
        dh = value.shape[2] // nh
        res = torch.empty(b, q, nh, dh, device=value.device)
        lv = (ctypes.c_int * (2 * nl))(*(n for hw in levels for n in hw))
        err = fn(value.data_ptr(), grids.data_ptr(), weights.data_ptr(), res.data_ptr(), lv, nl, b,
                 value.shape[1], q, nh, dh, npts, DG._DTYPE_CODES[value.dtype], DG._DTYPE_CODES[weights.dtype],
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the earlier kernel failed: cudaError {err}")
        return res

    return run


def main() -> None:
    if len(sys.argv) != 2 or not os.path.isdir(sys.argv[1]):
        raise SystemExit(__doc__)
    smi = S.phase_device()
    S.phase_build()
    parent = parent_kernel(Path(sys.argv[1]).resolve())
    gen = torch.Generator(device=S.DEV).manual_seed(0)
    result = {}
    for name, b, q, nh, dh, levels, npts, vdt, wdt, kind in S.DEFORM_CASES:
        value, grids, weights = S.deform_inputs(b, q, nh, dh, levels, npts, vdt, wdt, kind, gen)
        want = DG.deform_gather_ref(value, levels, grids, weights)
        tol = DG.deform_gather_tolerance(value, weights)
        errs = [float((f(value, levels, grids, weights) - want).abs().max()) for f in (parent, DG.deform_gather)]
        S.check(max(errs) <= tol, f"{name}: {errs} against the plain version, tol {tol:.3e}")
        turns = [S._median_ms(lambda f=f: f(value, levels, grids, weights))
                 for f in (parent, DG.deform_gather, DG.deform_gather, parent)]
        plan = DG.plan_for(value, grids, weights).describe()
        result[name] = dict(parent_ms=(turns[0] + turns[3]) / 2, ms=(turns[1] + turns[2]) / 2, plan=plan)
        S.log(f"[ab] {name}: earlier design {turns[0]:.4f} / {turns[3]:.4f} ms, this tree {turns[1]:.4f} / "
              f"{turns[2]:.4f} ms ({plan}); max errors {errs[0]:.3e} / {errs[1]:.3e} (tol {tol:.3e}); on {smi}")
        del value, grids, weights, want
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
