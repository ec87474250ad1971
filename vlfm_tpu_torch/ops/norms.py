"""LayerNorm with f32 statistics: the CUDA kernel and its plain version.

Counterpart of ``vlfm_tpu/ops/norms.py`` (the Pallas TPU kernel
``_ln_kernel`` and its ``layer_norm`` wrapper). The kernel itself is
``vlfm_tpu_torch/csrc/layer_norm.cu``, built by ``kernels/build.py`` at its
first launch.

``layer_norm`` routes by the device of its input: a CPU tensor goes to
``layer_norm_ref``; a CUDA tensor goes to the kernel, or the call raises.
There is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import torch

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


def bf16_tolerance(want: torch.Tensor, floor: float = 1e-6) -> torch.Tensor:
    """What the kernel's bf16 output may differ from ``layer_norm_ref`` by,
    per element: one bf16 ulp of the plain result (8 significand bits), at
    least ``floor``. Near zero a bf16 ulp is finer than the f32 rounding of
    the mean, which two summation orders need not share."""
    e = torch.floor(torch.log2(want.abs().float().clamp_min(2.0**-126)))
    return torch.exp2(e - 7).clamp_min(floor)


def _check_cuda_args(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, max_d: int) -> None:
    d = x.shape[-1]
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"layer_norm kernel takes float32 or bfloat16 input, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("layer_norm kernel needs a contiguous input")
    if not 1 <= d <= max_d:
        raise ValueError(f"layer_norm kernel takes 1 <= D <= {max_d}, got D={d}")
    for name, p in (("scale", scale), ("bias", bias)):
        if p.device != x.device:
            raise ValueError(f"{name} is on {p.device}, input on {x.device}")
        if p.dtype != torch.float32:
            raise TypeError(f"layer_norm kernel needs float32 {name}, got {p.dtype}")
        if p.shape != (d,) or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({d},) tensor, got {tuple(p.shape)}")


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """LayerNorm over the last axis of any leading shape.

    CPU tensors take ``layer_norm_ref``. CUDA tensors launch the kernel on the
    current stream; ``layer_norm.launches`` counts those launches.
    """
    if x.device.type == "cpu":
        return layer_norm_ref(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm runs on CPU or CUDA tensors, got {x.device}")
    from vlfm_tpu_torch.kernels.build import load_library

    lib = load_library()
    _check_cuda_args(x, scale, bias, lib.vlfm_layer_norm_max_d())
    out = torch.empty_like(x)
    d = x.shape[-1]
    rows = x.numel() // d
    if rows == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.vlfm_layer_norm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        rows, d, float(eps), _DTYPE_CODES[x.dtype], stream,
    )
    if err != 0:
        raise RuntimeError(f"layer_norm kernel launch failed: cudaError {err}")
    layer_norm.launches += 1
    return out


layer_norm.launches = 0
