"""FOV-cone visibility ray-march over the occupancy grid (fog of war).

Counterpart of ``vlfm_tpu/ops/fog_of_war.py`` (which replaces
``frontier_exploration.utils.fog_of_war.reveal_fog_of_war``,
obstacle_map.py:117-124), with the same f32 expressions: rays across the
camera FOV sample the navigable window at unit steps, each ray's first
blocked step is its hit distance, and every cell of the window is revealed
iff it lies inside the cone, nearer than the hit of its nearest ray and
within range. Bearings go through ``atan2``, whose last ulp differs between
PyTorch and XLA and between CPU and CUDA, so a few cells on a ray boundary
may flip (as in ``ops/cone.py``). Each lane of the batch has its own window
and heading.
"""

from __future__ import annotations

import math

import torch

from benchmark.frozen.ops.sparse import first_true


def _linspace(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """``jnp.linspace``'s arithmetic: start*(1-s) + stop*s, s = i/(num-1),
    with ``stop`` itself as the last value."""
    div = num - 1
    dev = start.device
    step = torch.arange(div, dtype=torch.float32, device=dev) / torch.full((), div, dtype=torch.float32, device=dev)
    out = start * (1 - step) + stop * step
    return torch.cat([out, stop.reshape(1)])


def reveal_fog_of_war_window(
    navigable_window: torch.Tensor,  # (B, W, W) bool, each agent at its window's centre
    heading: torch.Tensor,  # (B,) world yaw, radians
    fov: float | torch.Tensor,  # radians
    max_line_len_px: float | torch.Tensor,  # max reveal radius in pixels
    *,
    num_rays: int = 240,
) -> torch.Tensor:
    """(B, W, W) bool revealed mask. Map convention: drow ~ +x, dcol ~ -y."""
    dev = navigable_window.device
    f32 = torch.float32
    b, w = navigable_window.shape[:2]
    half = w // 2
    k_steps = half  # rays cannot leave the window
    fov_t, max_len = (v.to(f32) if torch.is_tensor(v) else torch.full((), v, dtype=f32, device=dev)
                      for v in (fov, max_line_len_px))

    bearings = heading[:, None] + _linspace(-fov_t / 2, fov_t / 2, num_rays)  # (B, R)
    drow = torch.cos(bearings)
    dcol = -torch.sin(bearings)
    steps = torch.arange(1, k_steps + 1, dtype=f32, device=dev)
    rr = torch.round(half + drow[..., None] * steps).to(torch.int64).clamp(0, w - 1)
    cc = torch.round(half + dcol[..., None] * steps).to(torch.int64).clamp(0, w - 1)
    blocked = ~torch.gather(navigable_window.reshape(b, -1), 1, (rr * w + cc).reshape(b, -1))
    blocked = blocked.reshape(b, num_rays, k_steps)  # (B, R, K)

    # first blocked step per ray (K+1 if never blocked)
    first_block = (first_true(blocked, -1) + 1).to(f32)
    hit_dist = torch.minimum(first_block, max_len)

    pr = torch.arange(w, dtype=f32, device=dev) - half
    dy = pr[:, None] + torch.zeros((1, w), dtype=f32, device=dev)
    dx = pr[None, :] + torch.zeros((w, 1), dtype=f32, device=dev)
    dist = torch.sqrt(dy * dy + dx * dx)
    bearing = torch.atan2(-dx, dy)  # atan2(-dcol, drow) -> world bearing
    # (bearing - heading + pi) mod 2pi - pi, as jnp.remainder computes it
    period = torch.full((), 2 * math.pi, dtype=f32, device=dev)
    r = torch.fmod(bearing - heading[:, None, None] + math.pi, period)
    r = torch.where((r != 0) & (r < 0), r + period, r)
    rel = r - math.pi
    inside = torch.abs(rel) <= fov_t / 2
    ray_idx = torch.round((rel + fov_t / 2) / fov_t * (num_rays - 1)).to(torch.int64).clamp(0, num_rays - 1)
    limit = torch.gather(hit_dist, 1, ray_idx.reshape(b, -1)).reshape(b, w, w)
    revealed = inside & (dist <= limit) & (dist <= max_len)
    revealed[:, half, half] = True  # the agent's own cell is always revealed
    return revealed
