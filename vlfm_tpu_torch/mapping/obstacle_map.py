"""Obstacle / explored map with frontier detection on the device.

Counterpart of ``vlfm_tpu/mapping/obstacle_map.py`` (reference:
vlfm/mapping/obstacle_map.py plus its ``frontier_exploration`` calls), with
the same arguments and the same steps per update:

1. fill depth holes, scale to meters, keep the pixels whose episodic
   height is in the obstacle band,
2. splat them into the obstacle grid (``ops/raster.py``),
3. navigable = NOT dilate(obstacles, agent-diameter kernel),
4. reveal the FOV cone against the navigable grid (``ops/fog_of_war.py``),
   dilate it 3x3, OR it into the explored area, clear non-navigable cells,
5. keep only the explored region connected to the agent (a flood from the
   agent's cell, ``ops/flood.py``),
6. detect frontier waypoints (``ops/frontier.py``).

Steps 1-4 touch only windows around the camera. Unlike the JAX version,
which returns new arrays, ``update`` writes the obstacle and navigable
windows into the state's tensors IN PLACE (as ``value_map.update`` does)
and returns a new state whose ``explored`` and frontiers are new tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vlfm_tpu_torch.device import default_device
from vlfm_tpu_torch.mapping.grid import GridSpec2D
from vlfm_tpu_torch.ops.flood import flood_from_seed
from vlfm_tpu_torch.ops.fog_of_war import reveal_fog_of_war_window
from vlfm_tpu_torch.ops.frontier import detect_frontiers
from vlfm_tpu_torch.ops.morphology import dilate
from vlfm_tpu_torch.ops.raster import splat_depth_to_window
from vlfm_tpu_torch.ops.windows import read_window, write_window
from vlfm_tpu_torch.utils.geometry import extract_yaw


class ObstacleMapState(NamedTuple):
    obstacles: torch.Tensor  # (S, S) bool
    navigable: torch.Tensor  # (S, S) bool
    explored: torch.Tensor  # (S, S) bool
    frontiers_xy: torch.Tensor  # (F, 2) float32 world meters
    frontiers_valid: torch.Tensor  # (F,) bool
    frontier_overflow: torch.Tensor  # () bool


def create(spec: GridSpec2D, max_frontiers: int = 32, *,
           device: torch.device | str = default_device()) -> ObstacleMapState:
    s = spec.storage_size
    return ObstacleMapState(
        obstacles=torch.zeros((s, s), dtype=torch.bool, device=device),
        navigable=torch.ones((s, s), dtype=torch.bool, device=device),
        explored=torch.zeros((s, s), dtype=torch.bool, device=device),
        frontiers_xy=torch.full((max_frontiers, 2), -1.0, dtype=torch.float32, device=device),
        frontiers_valid=torch.zeros(max_frontiers, dtype=torch.bool, device=device),
        frontier_overflow=torch.zeros((), dtype=torch.bool, device=device),
    )


def from_numpy(arrays, *, device: torch.device | str = default_device()) -> ObstacleMapState:
    """A state from the six arrays of an ``ObstacleMapState`` (numpy, or
    anything ``np.asarray`` takes, such as the JAX state's leaves), in
    field order; so both packages can start from the same mid-episode map."""
    dtypes = (torch.bool, torch.bool, torch.bool, torch.float32, torch.bool, torch.bool)
    return ObstacleMapState(*(
        torch.as_tensor(np.array(a), dtype=dt, device=device) for a, dt in zip(arrays, dtypes)
    ))


def reset(state: ObstacleMapState) -> ObstacleMapState:
    """Clear the map in place."""
    state.obstacles.zero_()
    state.navigable.fill_(True)
    state.explored.zero_()
    state.frontiers_xy.fill_(-1.0)
    state.frontiers_valid.zero_()
    state.frontier_overflow.zero_()
    return state


def fill_depth_holes(depth: torch.Tensor, max_hole_fraction: float = 0.33) -> torch.Tensor:
    """Set zero-depth holes to 1.0 ("far") unless most of the frame is holes
    (stands in for img_utils.fill_small_holes, see the JAX module)."""
    holes = depth == 0
    fill = holes.to(torch.float32).mean() < max_hole_fraction
    return torch.where(holes & fill, 1.0, depth)


def _agent_kernel_size(spec: GridSpec2D, agent_radius: float) -> int:
    # Reference: kernel = round(pixels_per_meter * agent_radius * 2) to odd
    # (obstacle_map.py:43-46).
    k = int(spec.pixels_per_meter * agent_radius * 2)
    return k + (k % 2 == 0)


def update(
    state: ObstacleMapState,
    spec: GridSpec2D,
    depth: torch.Tensor,  # (H, W) normalized [0, 1]
    tf_camera_to_episodic: torch.Tensor,
    min_depth: float,
    max_depth: float,
    fx: float,
    fy: float,
    topdown_fov: float,
    min_height: float,
    max_height: float,
    area_thresh_m2: float,
    full_prune: torch.Tensor | bool = True,
    *,
    agent_radius: float = 0.18,
    window: int = 224,
    splat_window: int = 288,
    explore: bool = True,
    update_obstacles: bool = True,
    max_frontier_cells: int = 512,
    max_frontiers: int = 32,
) -> ObstacleMapState:
    dev = state.obstacles.device
    f32 = torch.float32
    cam_xy = tf_camera_to_episodic[:2, 3]
    yaw = extract_yaw(tf_camera_to_episodic)
    rc = spec.to_storage(spec.xy_to_px(cam_xy))
    kernel = _agent_kernel_size(spec, agent_radius)
    halo = kernel // 2
    obstacles, navigable = state.obstacles, state.navigable

    if update_obstacles:
        filled = fill_depth_holes(depth)
        scaled = filled * (max_depth - min_depth) + min_depth
        # Episodic height of each pixel: z_epi = cam_z - (v - H/2) * z / fy.
        hgt = depth.shape[0]
        v = torch.arange(hgt, dtype=scaled.dtype, device=dev)[:, None]
        z_epi = tf_camera_to_episodic[2, 3] - (v - hgt // 2) * scaled / torch.tensor(fy, dtype=f32, device=dev)
        # Unfilled holes would read as phantom obstacles at min_depth.
        in_band = (filled > 0) & (z_epi >= min_height) & (z_epi <= max_height)
        splat = splat_depth_to_window(
            scaled, in_band, yaw, fx, max_depth, window=splat_window, pixels_per_meter=spec.pixels_per_meter
        )
        write_window(obstacles, read_window(obstacles, rc, splat_window) | splat, rc)
        # Navigable with a halo, so the dilation at the window edge is right.
        nav_h = ~dilate(read_window(obstacles, rc, splat_window + 2 * halo), kernel)
        nav_w = nav_h[halo : halo + splat_window, halo : halo + splat_window] if halo else nav_h
        write_window(navigable, nav_w, rc)

    if not explore:
        return state._replace(obstacles=obstacles, navigable=navigable)

    # The scalars are f32 before they are combined, as in the JAX jit.
    max_depth_px = torch.tensor(max_depth, dtype=f32, device=dev) * spec.pixels_per_meter
    revealed = reveal_fog_of_war_window(read_window(navigable, rc, window), yaw, topdown_fov, max_depth_px)
    revealed = dilate(revealed, 3)  # obstacle_map.py:125
    explored = state.explored.clone()
    write_window(explored, read_window(explored, rc, window) | revealed, rc)
    explored = explored & navigable

    # Keep only the region containing the agent. The flood is seeded with
    # (previous kept region & current explored) | a 9x9 agent disk; with
    # ``full_prune`` (every 8th step in the policy) the agent disk alone.
    agent_seed = torch.zeros_like(explored)
    write_window(agent_seed, torch.ones((9, 9), dtype=torch.bool, device=dev), rc)
    prune = torch.as_tensor(full_prune, dtype=torch.bool, device=dev)
    seed = agent_seed | (state.explored & explored & ~prune)
    kept = flood_from_seed(explored, seed)
    explored = torch.where(kept.any(), kept, explored)

    fr = detect_frontiers(
        navigable,
        explored,
        torch.tensor(area_thresh_m2, dtype=f32, device=dev) * spec.pixels_per_meter**2,
        max_cells=max_frontier_cells,
        max_frontiers=max_frontiers,
    )
    fxy = spec.px_to_xy(fr.waypoints_px - spec.pad)
    fxy = torch.where(fr.valid[:, None], fxy, 0.0)
    return ObstacleMapState(
        obstacles=obstacles,
        navigable=navigable,
        explored=explored,
        frontiers_xy=fxy,
        frontiers_valid=fr.valid,
        frontier_overflow=fr.overflow,
    )
