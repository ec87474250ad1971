"""Scatter-free top-down obstacle splat: polar histogram + cartesian gather.

Counterpart of ``vlfm_tpu/ops/raster.py``, with the same f32 expressions.
Instead of back-projecting every depth pixel to a 3-D point
(obstacle_map.py:92-101), the in-band pixels fill a POLAR OCCUPANCY
HISTOGRAM (image column x radial bin, one bin per grid cell), which is
dilated along the column axis by the angular footprint of one grid cell at
each radius and then resampled into the cartesian window with one gather
per cell.

The JAX version keeps the histogram bit-packed (32 bins per uint32 word)
and OR-reduces one-bit words; here it is a (W, R) bool tensor filled by
``index_fill_`` (every write sets True, so duplicate indices agree) and
dilated by max pools. Every bin holds the same bit as the JAX word does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# Must cover the cone's far CORNERS, radius max_depth / cos(hfov/2): 6.5 m
# for the 79-degree/5 m envelope, 130 cells at 20 px/m.
_RADIAL_BINS = 160
_HALVES = (1, 2, 4, 8, 16, 32)  # column-dilation ladder, half-widths


def _dilate_cols(hist: torch.Tensor, half: int) -> torch.Tensor:
    """OR-dilate a (W, R) bool histogram along W by +-``half`` columns."""
    x = hist.to(torch.float32).t()[None]  # (1, R, W)
    return F.max_pool1d(x, 2 * half + 1, stride=1, padding=half)[0].t() > 0


@functools.lru_cache(maxsize=8)
def _window_geometry(window: int, pixels_per_meter: int):
    """The window's static per-cell offsets and radial bins (numpy f32)."""
    pps = float(pixels_per_meter)
    half = window // 2
    dr = (np.arange(window, dtype=np.float32) - half)[:, None] / pps
    dc = (np.arange(window, dtype=np.float32) - half)[None, :] / pps
    radial = np.sqrt(dr * dr + dc * dc)
    rbin = np.round(radial * pps).astype(np.int32)
    rbin_ok = (rbin >= 0) & (rbin < _RADIAL_BINS)
    rbin = np.clip(rbin, 0, _RADIAL_BINS - 1)
    dx = dr + np.zeros((1, window), np.float32)
    dy = -dc + np.zeros((window, 1), np.float32)
    return dx, dy, rbin.astype(np.int64), rbin_ok


def splat_depth_to_window(
    depth_m: torch.Tensor,  # (H, W) metric z-depth
    in_band: torch.Tensor,  # (H, W) pixels whose episodic height is in range
    yaw: torch.Tensor,
    fx: float,
    max_depth: float,
    *,
    window: int = 224,
    pixels_per_meter: int = 20,
) -> torch.Tensor:
    """(window, window) bool obstacle mask around the camera (at centre)."""
    dev = depth_m.device
    f32 = torch.float32
    h, w = depth_m.shape
    pps = float(pixels_per_meter)
    fx_t = torch.tensor(fx, dtype=f32, device=dev)

    u = torch.arange(w, dtype=f32, device=dev)
    tan_phi = (u - w // 2) / fx_t
    r_pix = depth_m * torch.sqrt(1.0 + tan_phi * tan_phi)[None, :]  # planar radius
    bins = torch.round(r_pix * pps).to(torch.int32)
    ok = in_band & (depth_m < max_depth) & (bins >= 0) & (bins < _RADIAL_BINS)

    # (W, R) occupancy: column u, radial bin b, set if any row hits it.
    n = w * _RADIAL_BINS
    cell = torch.where(ok, u.to(torch.int64)[None, :] * _RADIAL_BINS + bins, n)
    hist = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    hist.index_fill_(0, cell.reshape(-1), True)
    hist = hist[:n].reshape(w, _RADIAL_BINS)

    # Column-dilate by the angular footprint of one grid cell at each radius:
    # reach(cols) ~= (cell_diag/2) / (r * dphi_min), with the conservative
    # minimum column spacing dphi_min = cos^2(fov/2)/fx. Each bin takes the
    # narrowest rung of the ladder that covers its reach.
    half_fov = torch.atan(torch.tensor(w / 2, dtype=f32, device=dev) / fx_t)
    cos_half = torch.cos(half_fov)
    dphi_min = cos_half * cos_half / fx_t
    half_diag = torch.tensor(0.71 / pps, dtype=f32, device=dev)
    r_of_bin = torch.arange(_RADIAL_BINS, dtype=f32, device=dev) / torch.tensor(pps, dtype=f32, device=dev)
    r_min = torch.tensor(0.05, dtype=f32, device=dev)
    reach = torch.ceil(half_diag / (torch.maximum(r_of_bin, r_min) * dphi_min)).to(torch.int32)
    halves = torch.tensor(_HALVES, dtype=f32, device=dev)
    sel = torch.searchsorted(halves, reach.to(f32)).clamp(0, len(_HALVES) - 1)  # (R,)
    variants = torch.stack([_dilate_cols(hist, k) for k in _HALVES])  # (V, W, R)
    hist_d = torch.gather(variants, 0, sel[None, None, :].expand(1, w, _RADIAL_BINS))[0]

    # Cartesian lookup: the cell's radial bin is static; its column follows
    # the bearing, u = W/2 + fx * tan(phi), phi = atan2(-left, fwd).
    dx_np, dy_np, rbin_np, rbin_ok_np = _window_geometry(window, pixels_per_meter)
    dx = torch.from_numpy(dx_np).to(dev)
    dy = torch.from_numpy(dy_np).to(dev)
    cos_t, sin_t = torch.cos(yaw), torch.sin(yaw)
    fwd = dx * cos_t + dy * sin_t
    left = -dx * sin_t + dy * cos_t
    col = torch.round(w // 2 + fx_t * (-left) / torch.clamp(fwd, min=1e-6)).to(torch.int32)
    inside = (fwd > 0.0) & (col >= 0) & (col < w) & torch.from_numpy(rbin_ok_np).to(dev)
    col = torch.clamp(col, 0, w - 1).to(torch.int64)
    return inside & hist_d[col, torch.from_numpy(rbin_np).to(dev)]
