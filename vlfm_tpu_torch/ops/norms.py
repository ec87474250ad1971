"""LayerNorm with f32 statistics: the CUDA kernel and its plain version.

Counterpart of ``vlfm_tpu/ops/norms.py`` (the Pallas TPU kernel
``_ln_kernel`` and its ``layer_norm`` wrapper). The kernel itself is
``vlfm_tpu_torch/csrc/layer_norm.cu``, built by ``kernels/build.py`` at its
first launch. It has two entries: ``layer_norm`` (y = LN(x)) and
``add_layer_norm`` (s = x + h, y = LN(s)), which folds the residual or
embedding add before a norm into the same launch.

Both route by the device of their input: a CPU tensor goes to the plain
version (``layer_norm_ref``, ``add_layer_norm_ref``); a CUDA tensor goes to
the kernel, or the call raises. There is no fallback from the kernel to the
plain version. The counter ``K1.launches`` (``utils/profiling.py``) counts
every launch of the kernel, from either entry; ``K1.fused_launches`` counts
the fused ones. Each call is a ``vlfm.K1`` span with its inputs' shapes
and dtype and the entry that ran (``plain``, ``add_keep_sum`` or ``add``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import torch

from vlfm_tpu_torch.utils.profiling import count, span

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm_ref(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """Plain PyTorch LayerNorm over the last axis: f32 mean, f32 variance of
    the centred values, result cast back to ``x.dtype``. Each statistic is
    a sum times 1/D, as in the Pallas kernel and the CUDA one."""
    inv_d = 1.0 / x.shape[-1]
    xf = x.to(torch.float32)
    c = xf - xf.sum(-1, keepdim=True) * inv_d
    var = (c * c).sum(-1, keepdim=True) * inv_d
    y = c * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def add_layer_norm_ref(
    x: torch.Tensor, h: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6, *,
    keep_sum: bool,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Plain version of ``add_layer_norm``: ``s = x + h`` (PyTorch's add,
    broadcasting ``h``), then ``layer_norm_ref(s)``. Returns ``(s, y)`` with
    ``keep_sum``, else ``y``."""
    s = x + h
    y = layer_norm_ref(s, scale, bias, eps)
    return (s, y) if keep_sum else y


def bf16_tolerance(want: torch.Tensor, floor: float = 1e-6) -> torch.Tensor:
    """What the kernel's bf16 output may differ from ``layer_norm_ref`` by,
    per element: one bf16 ulp of the plain result (8 significand bits), at
    least ``floor``. Near zero a bf16 ulp is finer than the f32 rounding of
    the mean, which two summation orders need not share."""
    e = torch.floor(torch.log2(want.abs().float().clamp_min(2.0**-126)))
    return torch.exp2(e - 7).clamp_min(floor)


@functools.cache
def _library():
    """The kernel library, its largest D and the getter of a device's
    current stream, looked up once, at the first CUDA call: a wrapper's host
    cost is paid on every launch."""
    from vlfm_tpu_torch.kernels.build import load_library

    lib = load_library()
    return lib, lib.vlfm_layer_norm_max_d(), torch._C._cuda_getCurrentRawStream


def _check_cuda_args(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, max_d: int) -> None:
    """Raise unless the kernel takes these arguments. Arguments it takes
    pass one boolean test; the messages are built only when it fails."""
    d = x.shape[-1]
    dev = x.device
    if (x.dtype in _DTYPE_CODES and 1 <= d <= max_d and x.is_contiguous()
            and scale.dtype == torch.float32 and bias.dtype == torch.float32
            and scale.shape == (d,) and bias.shape == (d,) and scale.is_contiguous() and bias.is_contiguous()
            and scale.device == dev and bias.device == dev):
        return
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"layer_norm kernel takes float32 or bfloat16 input, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("layer_norm kernel needs a contiguous input")
    if not 1 <= d <= max_d:
        raise ValueError(f"layer_norm kernel takes 1 <= D <= {max_d}, got D={d}")
    for name, p in (("scale", scale), ("bias", bias)):
        if p.device != dev:
            raise ValueError(f"{name} is on {p.device}, input on {dev}")
        if p.dtype != torch.float32:
            raise TypeError(f"layer_norm kernel needs float32 {name}, got {p.dtype}")
        if p.shape != (d,) or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({d},) tensor, got {tuple(p.shape)}")


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """LayerNorm over the last axis of any leading shape.

    CPU tensors take ``layer_norm_ref``. CUDA tensors launch the kernel on the
    current stream; the counter ``K1.launches`` counts those launches.
    """
    with span("vlfm.K1", x=x, entry="plain"):
        if not x.is_cuda:
            if x.device.type != "cpu":
                raise ValueError(f"layer_norm runs on CPU or CUDA tensors, got {x.device}")
            return layer_norm_ref(x, scale, bias, eps)
        lib, max_d, raw_stream = _library()
        _check_cuda_args(x, scale, bias, max_d)
        out = torch.empty_like(x)
        d = x.shape[-1]
        rows = x.numel() // d
        if rows == 0:
            return out
        err = lib.vlfm_layer_norm(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            rows, d, float(eps), _DTYPE_CODES[x.dtype], raw_stream(x.get_device()),
        )
        if err != 0:
            raise RuntimeError(f"layer_norm kernel launch failed: cudaError {err}")
        count("K1.launches")
        return out


def _h_rows(x: torch.Tensor, h: torch.Tensor) -> int:
    """The rows of ``h`` that the sum cycles through. ``h`` is x's shape or,
    leading ones aside, x's trailing dimensions (a per-token table broadcast
    over the batch)."""
    xs = x.shape
    if h.shape != xs:
        dims = h.shape
        while len(dims) > 1 and dims[0] == 1:
            dims = dims[1:]
        if len(dims) > len(xs) or dims != xs[len(xs) - len(dims):]:
            raise ValueError(f"add_layer_norm needs h's shape {tuple(h.shape)} to be x's "
                             f"{tuple(xs)} or to end in its trailing dimensions")
    return h.numel() // xs[-1]


def add_layer_norm(
    x: torch.Tensor, h: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6, *,
    keep_sum: bool,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """LayerNorm of ``s = x + h`` over the last axis in one launch.

    ``x`` and ``h`` share a dtype; ``h`` has x's shape or, leading ones
    aside, its trailing dimensions (a position table over a batch).
    Returns ``(s, y)`` with ``keep_sum`` (a pre-norm site, where ``s`` is
    the next residual), else ``y`` (post-norm: ``s`` is never stored).
    CPU tensors take ``add_layer_norm_ref``. CUDA tensors launch the
    kernel on the current stream; each launch adds one to the counters
    ``K1.fused_launches`` and ``K1.launches``.
    """
    with span("vlfm.K1", x=x, h=h, entry="add_keep_sum" if keep_sum else "add"):
        if h.dtype != x.dtype:
            raise TypeError(f"add_layer_norm takes x and h of one dtype, got {x.dtype} and {h.dtype}")
        h_rows = _h_rows(x, h)
        if not x.is_cuda:
            if x.device.type != "cpu":
                raise ValueError(f"add_layer_norm runs on CPU or CUDA tensors, got {x.device}")
            return add_layer_norm_ref(x, h, scale, bias, eps, keep_sum=keep_sum)
        lib, max_d, raw_stream = _library()
        _check_cuda_args(x, scale, bias, max_d)
        if h.device != x.device:
            raise ValueError(f"h is on {h.device}, x on {x.device}")
        if not h.is_contiguous():
            raise ValueError("add_layer_norm kernel needs a contiguous h")
        y = torch.empty_like(x)
        s: Optional[torch.Tensor] = torch.empty_like(x) if keep_sum else None
        d = x.shape[-1]
        rows = x.numel() // d
        if rows > 0:
            err = lib.vlfm_add_layer_norm(
                x.data_ptr(), h.data_ptr(), h_rows, scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                None if s is None else s.data_ptr(), rows, d, float(eps), _DTYPE_CODES[x.dtype],
                raw_stream(x.get_device()),
            )
            if err != 0:
                raise RuntimeError(f"add_layer_norm kernel launch failed: cudaError {err}")
            count("K1.launches")
            count("K1.fused_launches")
        return (s, y) if keep_sum else y
