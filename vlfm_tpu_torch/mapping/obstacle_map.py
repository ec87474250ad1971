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

The state is batch-first: B episodes ("lanes"), each with its own grids,
pose, depth and prune flag, updated by one call, as JAX's vmapped step
updates them. One episode is B = 1. On the card nothing is read back to
the host: the flood and the frontiers' labelling run as kernels
(``ops/flood.py``). On the CPU their plain loops read one convergence check
per few sweeps for all lanes.
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
from vlfm_tpu_torch.ops.windows import read_window, window_index, write_window
from vlfm_tpu_torch.utils.geometry import extract_yaw


class ObstacleMapState(NamedTuple):
    obstacles: torch.Tensor  # (B, S, S) bool
    navigable: torch.Tensor  # (B, S, S) bool
    explored: torch.Tensor  # (B, S, S) bool
    frontiers_xy: torch.Tensor  # (B, F, 2) float32 world meters
    frontiers_valid: torch.Tensor  # (B, F) bool
    frontier_overflow: torch.Tensor  # (B,) bool


def create(spec: GridSpec2D, max_frontiers: int = 32, *, batch: int = 1,
           device: torch.device | str = default_device()) -> ObstacleMapState:
    s = spec.storage_size
    return ObstacleMapState(
        obstacles=torch.zeros((batch, s, s), dtype=torch.bool, device=device),
        navigable=torch.ones((batch, s, s), dtype=torch.bool, device=device),
        explored=torch.zeros((batch, s, s), dtype=torch.bool, device=device),
        frontiers_xy=torch.full((batch, max_frontiers, 2), -1.0, dtype=torch.float32, device=device),
        frontiers_valid=torch.zeros((batch, max_frontiers), dtype=torch.bool, device=device),
        frontier_overflow=torch.zeros(batch, dtype=torch.bool, device=device),
    )


def from_numpy(arrays, *, device: torch.device | str = default_device()) -> ObstacleMapState:
    """A state from the six arrays of an ``ObstacleMapState`` (numpy, or
    anything ``np.asarray`` takes, such as the JAX state's leaves), in field
    order, each with a leading lane axis; so both packages can start from
    the same mid-episode maps. Stack single JAX states on axis 0 first."""
    dtypes = (torch.bool, torch.bool, torch.bool, torch.float32, torch.bool, torch.bool)
    return ObstacleMapState(*(
        torch.as_tensor(np.array(a), dtype=dt, device=device) for a, dt in zip(arrays, dtypes)
    ))


def reset(state: ObstacleMapState, lanes: torch.Tensor | None = None) -> ObstacleMapState:
    """Clear the map in place: every lane, or the lanes where the (B,) bool
    ``lanes`` is set (episodes that start anew while the others go on)."""
    if lanes is None:
        lanes = torch.ones(state.obstacles.shape[0], dtype=torch.bool, device=state.obstacles.device)
    grid = lanes[:, None, None]
    state.obstacles.masked_fill_(grid, False)
    state.navigable.masked_fill_(grid, True)
    state.explored.masked_fill_(grid, False)
    state.frontiers_xy.masked_fill_(grid, -1.0)
    state.frontiers_valid.masked_fill_(lanes[:, None], False)
    state.frontier_overflow.masked_fill_(lanes, False)
    return state


def fill_depth_holes(depth: torch.Tensor, max_hole_fraction: float = 0.33) -> torch.Tensor:
    """Set zero-depth holes of each (B, H, W) frame to 1.0 ("far") unless
    most of that frame is holes (stands in for img_utils.fill_small_holes,
    see the JAX module)."""
    holes = depth == 0
    fill = holes.to(torch.float32).mean(dim=(-2, -1), keepdim=True) < max_hole_fraction
    return torch.where(holes & fill, 1.0, depth)


def _agent_kernel_size(spec: GridSpec2D, agent_radius: float) -> int:
    # Reference: kernel = round(pixels_per_meter * agent_radius * 2) to odd
    # (obstacle_map.py:43-46).
    k = int(spec.pixels_per_meter * agent_radius * 2)
    return k + (k % 2 == 0)


def update(
    state: ObstacleMapState,
    spec: GridSpec2D,
    depth: torch.Tensor,  # (B, H, W) normalized [0, 1]
    tf_camera_to_episodic: torch.Tensor,  # (B, 4, 4)
    min_depth: float,
    max_depth: float,
    fx: float,
    fy: float,
    topdown_fov: float,
    min_height: float,
    max_height: float,
    area_thresh_m2: float,
    full_prune: torch.Tensor | bool = True,  # (B,) bool, or one flag for all lanes
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
    b, size = state.obstacles.shape[:2]
    cam_xy = tf_camera_to_episodic[:, :2, 3]
    yaw = extract_yaw(tf_camera_to_episodic)  # (B,)
    rc = spec.to_storage(spec.xy_to_px(cam_xy))  # (B, 2)
    kernel = _agent_kernel_size(spec, agent_radius)
    halo = kernel // 2
    obstacles, navigable = state.obstacles, state.navigable

    if update_obstacles:
        filled = fill_depth_holes(depth)
        scaled = filled * (max_depth - min_depth) + min_depth
        # Episodic height of each pixel: z_epi = cam_z - (v - H/2) * z / fy.
        hgt = depth.shape[1]
        v = torch.arange(hgt, dtype=scaled.dtype, device=dev)[:, None]
        cam_z = tf_camera_to_episodic[:, 2, 3][:, None, None]
        z_epi = cam_z - (v - hgt // 2) * scaled / torch.full((), fy, dtype=f32, device=dev)
        # Unfilled holes would read as phantom obstacles at min_depth.
        in_band = (filled > 0) & (z_epi >= min_height) & (z_epi <= max_height)
        splat = splat_depth_to_window(
            scaled, in_band, yaw, fx, max_depth, window=splat_window, pixels_per_meter=spec.pixels_per_meter
        )
        at_splat = window_index(rc, splat_window, size)
        write_window(obstacles, read_window(obstacles, at_splat) | splat, at_splat)
        # Navigable with a halo, so the dilation at the window edge is right.
        nav_h = ~dilate(read_window(obstacles, window_index(rc, splat_window + 2 * halo, size)), kernel)
        nav_w = nav_h[:, halo : halo + splat_window, halo : halo + splat_window] if halo else nav_h
        write_window(navigable, nav_w, at_splat)

    if not explore:
        return state._replace(obstacles=obstacles, navigable=navigable)

    # The scalars are f32 before they are combined, as in the JAX jit.
    max_depth_px = torch.full((), max_depth, dtype=f32, device=dev) * spec.pixels_per_meter
    at_window = window_index(rc, window, size)
    revealed = reveal_fog_of_war_window(read_window(navigable, at_window), yaw, topdown_fov, max_depth_px)
    revealed = dilate(revealed, 3)  # obstacle_map.py:125
    explored = state.explored.clone()
    write_window(explored, read_window(explored, at_window) | revealed, at_window)
    explored = explored & navigable

    # Keep only the region containing the agent. The flood is seeded with
    # (previous kept region & current explored) | a 9x9 agent disk; with
    # ``full_prune`` (every 8th step in the policy) the agent disk alone.
    agent_seed = torch.zeros_like(explored)
    write_window(agent_seed, torch.ones((b, 9, 9), dtype=torch.bool, device=dev), window_index(rc, 9, size))
    prune = (full_prune.to(torch.bool) if torch.is_tensor(full_prune)
             else torch.full((b,), bool(full_prune), dtype=torch.bool, device=dev))
    seed = agent_seed | (state.explored & explored & ~prune.reshape(-1, 1, 1))
    kept = flood_from_seed(explored, seed)
    explored = torch.where(kept.reshape(b, -1).any(dim=1)[:, None, None], kept, explored)

    fr = detect_frontiers(
        navigable,
        explored,
        torch.full((), area_thresh_m2, dtype=f32, device=dev) * spec.pixels_per_meter**2,
        max_cells=max_frontier_cells,
        max_frontiers=max_frontiers,
    )
    fxy = spec.px_to_xy(fr.waypoints_px - spec.pad)
    fxy = torch.where(fr.valid[..., None], fxy, 0.0)
    return ObstacleMapState(
        obstacles=obstacles,
        navigable=navigable,
        explored=explored,
        frontiers_xy=fxy,
        frontiers_valid=fr.valid,
        frontier_overflow=fr.overflow,
    )
