"""Analytic FOV-cone visibility/confidence over a window around the camera.

Counterpart of ``vlfm_tpu/ops/cone.py``, with the same expressions in the
same order so f32 results match the JAX version. Every pixel of a fixed
(window x window) region centred on the camera computes its (forward,
lateral) offset in the camera frame directly, tests it against the FOV
wedge, the range and the per-bearing depth limit, and gets the reference's
cos^2 confidence falloff. Each lane of the batch has its own depth row and
yaw.

Conventions (see ``mapping/grid.py``): row ~ +x world, col ~ -y world.
Depth-image column 0 is the LEFT edge of the view and maps to bearing -fov/2.
"""

from __future__ import annotations

import math

import torch

MIN_CONFIDENCE = 0.25  # reference: value_map.py:40


def depth_row_max(depth: torch.Tensor, min_depth: float, max_depth: float) -> torch.Tensor:
    """Squash (..., H, W) normalized [0,1] depth to (..., W) per-column max
    metric depth."""
    return torch.amax(depth, dim=-2) * (max_depth - min_depth) + min_depth


def visible_confidence_window(
    depth_row_m: torch.Tensor,  # (B, W)
    yaw: torch.Tensor,  # (B,)
    fov: torch.Tensor,
    max_depth: torch.Tensor,
    *,
    window: int = 256,
    pixels_per_meter: int = 20,
) -> torch.Tensor:
    """(B, window, window) confidence-weighted visibility mask around each
    camera.

    The camera sits at the window centre with heading ``yaw``. A pixel is
    visible iff it is inside the FOV wedge, within ``max_depth`` radially, and
    its forward coordinate is at most the interpolated per-bearing depth limit
    from ``depth_row_m``. Visible pixels get cos^2 angular confidence remapped
    to [MIN_CONFIDENCE, 1]; everything else is 0. ``fov`` and ``max_depth``
    are f32 scalar tensors on the map's device.
    """
    dev = depth_row_m.device
    b, w = depth_row_m.shape
    pps = float(pixels_per_meter)
    half = window // 2

    ar = torch.arange(window, dtype=torch.float32, device=dev) - half
    dr = ar[:, None] / pps  # world dx
    dc = ar[None, :] / pps
    dx = dr + torch.zeros((1, window), dtype=torch.float32, device=dev)
    dy = -dc + torch.zeros((window, 1), dtype=torch.float32, device=dev)

    cos_t, sin_t = torch.cos(yaw)[:, None, None], torch.sin(yaw)[:, None, None]
    fwd = dx * cos_t + dy * sin_t
    left = -dx * sin_t + dy * cos_t
    # Bearing within the view: negative on the LEFT (column 0 of the image).
    phi = torch.atan2(-left, fwd)
    radial = torch.sqrt(fwd * fwd + left * left)

    # Per-bearing forward depth limit: the column-angle grid is uniform, so
    # interpolation is index arithmetic plus one lerp.
    u = torch.clamp((phi + fov / 2) / fov * (w - 1), 0.0, w - 1.0)
    i0 = torch.floor(u).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=w - 1)
    frac = u - i0.to(u.dtype)

    def row_at(i):
        return torch.gather(depth_row_m, 1, i.reshape(b, -1)).reshape(i.shape)

    z_limit = row_at(i0) * (1.0 - frac) + row_at(i1) * frac

    half_px = 0.5 / pps  # half-pixel tolerance vs. the rasterized contour
    visible = (torch.abs(phi) <= fov / 2) & (radial <= max_depth) & (fwd <= z_limit + half_px)

    # cos^2 falloff on |bearing|: [0, fov/2] -> [0, pi/2], then
    # [0, 1] -> [MIN_CONFIDENCE, 1].
    ang = torch.abs(phi) * (math.pi / 2) / (fov / 2)
    conf = torch.cos(ang) ** 2
    conf = conf * (1.0 - MIN_CONFIDENCE) + MIN_CONFIDENCE
    return torch.where(visible, conf, 0.0).to(torch.float32)
