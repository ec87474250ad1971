"""Separable image resize as two dense matmuls.

Counterpart of ``vlfm_tpu/ops/resize.py``: the same numpy-built
interpolation matrices (half-pixel centres; downscales anti-aliased by
kernel dilation and renormalised, as ``jax.image.resize``), applied with
``torch.einsum`` in f32. BLIP-2 preprocessing uses the cubic (Keys a=-0.5)
form; OWL-ViT's and SAM's preprocessing and the mask resize use the linear
one.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _kernel(name: str):
    if name == "linear":
        return (lambda t: np.maximum(0.0, 1.0 - np.abs(t))), 1.0
    if name == "cubic":  # Keys cubic, a = -0.5 (jax.image.resize "cubic")
        a = -0.5

        def f(t):
            t = np.abs(t)
            return np.where(
                t <= 1.0,
                ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0,
                np.where(t < 2.0, ((t - 5.0) * t + 8.0) * t * a - 4.0 * a, 0.0),
            )

        return f, 2.0
    raise ValueError(f"unknown resize kernel {name!r}")


@lru_cache(maxsize=64)
def _interp_matrix(n_in: int, n_out: int, kernel: str = "linear") -> np.ndarray:
    """(n_out, n_in) resampling weights, half-pixel convention, for both
    magnification and (anti-aliased) minification."""
    f, support = _kernel(kernel)
    scale = n_in / n_out
    dilation = max(scale, 1.0)  # antialias: widen the kernel when shrinking
    w = np.zeros((n_out, n_in), np.float32)
    taps = np.arange(n_in, dtype=np.float64)
    for o in range(n_out):
        src = (o + 0.5) * scale - 0.5
        wt = f((taps - src) / dilation)
        s = wt.sum()
        if s > 0:
            w[o] = (wt / s).astype(np.float32)
    return w


@lru_cache(maxsize=64)
def _matrix(n_in: int, n_out: int, kernel: str, device: torch.device) -> torch.Tensor:
    """The weights on ``device``, copied there once: a copy from pageable
    host memory waits for the device, so a per-call copy would add a host
    sync to every resize on the card. Callers only read it."""
    return torch.from_numpy(_interp_matrix(n_in, n_out, kernel)).to(device)


def resize_matmul(x: torch.Tensor, h_out: int, w_out: int, method: str = "linear") -> torch.Tensor:
    """Resize the (..., H, W, C) spatial axes to (h_out, w_out) via two dense
    matmuls. f32 accumulation; output keeps the input dtype."""
    h_in, w_in = x.shape[-3], x.shape[-2]
    dt = x.dtype
    out = x
    if h_in != h_out:
        R = _matrix(h_in, h_out, method, x.device)
        out = torch.einsum("oh,...hwc->...owc", R, out.to(torch.float32))
    if w_in != w_out:
        C = _matrix(w_in, w_out, method, x.device)
        out = torch.einsum("ow,...hwc->...hoc", C, out.to(torch.float32))
    return out.to(dt)


def resize_bilinear(x: torch.Tensor, h_out: int, w_out: int) -> torch.Tensor:
    return resize_matmul(x, h_out, w_out, "linear")


def resize_bilinear_hw(x: torch.Tensor, h_out: int, w_out: int) -> torch.Tensor:
    """Same for channel-less (..., H, W) tensors (depth, masks)."""
    h_in, w_in = x.shape[-2], x.shape[-1]
    dt = x.dtype
    out = x
    if h_in != h_out:
        R = _matrix(h_in, h_out, "linear", x.device)
        out = torch.einsum("oh,...hw->...ow", R, out.to(torch.float32))
    if w_in != w_out:
        C = _matrix(w_in, w_out, "linear", x.device)
        out = torch.einsum("ow,...hw->...ho", C, out.to(torch.float32))
    return out.to(dt)
