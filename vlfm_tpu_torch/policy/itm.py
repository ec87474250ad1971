"""The map half of the ITM policy step.

Counterpart of the parts of ``vlfm_tpu/policy/itm.py:step`` that need no
object map or PointNav: the obstacle-map update with its frontiers
(itm.py:124-140), fusing ITM cosines into the value map (itm.py:142-156),
scoring the frontiers by the value-map median within 0.5 m (V2,
itm.py:212-225), the frontier choice, and the greedy rho-theta controller
(itm.py:253-261).

``update_obstacles``, ``fuse_view`` and ``decide`` have no namesakes in the
JAX module: they are the three parts of ``step`` that this slice needs, and
they go when ``step`` itself is ported (ROADMAP Queue 1 item 3), which then
owns the maps and the decision.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from vlfm_tpu_torch.config import VLFMConfig
from vlfm_tpu_torch.mapping import obstacle_map as OM
from vlfm_tpu_torch.mapping import value_map as VM
from vlfm_tpu_torch.mapping.grid import GridSpec2D
from vlfm_tpu_torch.policy import acyclic as AC
from vlfm_tpu_torch.policy.frontier_selection import FrontierChoice, select_best_frontier
from vlfm_tpu_torch.utils.geometry import rho_theta

STOP, MOVE_FORWARD, TURN_LEFT, TURN_RIGHT = 0, 1, 2, 3  # habitat_policies.py:54-58

FUSION_TYPES = {
    "default": VM.FUSION_DEFAULT,
    "replace": VM.FUSION_REPLACE,
    "equal_weighting": VM.FUSION_EQUAL_WEIGHTING,
}


class Decision(NamedTuple):
    choice: FrontierChoice
    waypoint_values: torch.Tensor  # (F, C)
    rho: torch.Tensor  # ()
    theta: torch.Tensor  # ()
    action: torch.Tensor  # () int32


def greedy_action(theta: torch.Tensor) -> torch.Tensor:
    """Deterministic rho-theta controller: turn toward the goal while it is
    more than 15 degrees off, else step forward."""
    half_turn = math.radians(15.0)
    return torch.where(
        theta > half_turn,
        TURN_LEFT,
        torch.where(theta < -half_turn, TURN_RIGHT, MOVE_FORWARD),
    ).to(torch.int32)


def update_obstacles(
    state: OM.ObstacleMapState,
    spec: GridSpec2D,
    cfg: VLFMConfig,
    depth: torch.Tensor,  # (H, W) normalized [0, 1]
    tf_camera_to_episodic: torch.Tensor,  # (4, 4)
    steps: int | torch.Tensor,  # the policy's step count before this step
) -> OM.ObstacleMapState:
    """One obstacle-map update with the policy's camera and map settings;
    every 8th step prunes the explored area from the agent alone."""
    cam = cfg.camera
    return OM.update(
        state,
        spec,
        depth,
        tf_camera_to_episodic,
        cam.min_depth,
        cam.max_depth,
        cam.fx,
        cam.fy,
        cam.hfov,
        min_height=cfg.min_obstacle_height,
        max_height=cfg.max_obstacle_height,
        area_thresh_m2=cfg.obstacle_map_area_threshold,
        full_prune=(steps % 8) == 0,
        agent_radius=cfg.agent_radius,
        max_frontier_cells=cfg.max_frontier_cells,
        max_frontiers=cfg.max_frontiers,
    )


def fuse_view(
    state: VM.ValueMapState,
    spec: GridSpec2D,
    cfg: VLFMConfig,
    cosines: torch.Tensor,  # (C,)
    depth: torch.Tensor,  # (H, W) normalized [0, 1]
    tf_camera_to_episodic: torch.Tensor,  # (4, 4)
) -> VM.ValueMapState:
    """One value-map update with the policy's camera and fusion settings."""
    cam = cfg.camera
    return VM.update(
        state,
        spec,
        cosines,
        depth,
        tf_camera_to_episodic,
        cam.min_depth,
        cam.max_depth,
        cam.hfov,
        use_max_confidence=cfg.use_max_confidence,
        fusion_type=FUSION_TYPES[cfg.map_fusion_type],
    )


def decide(
    state: VM.ValueMapState,
    spec: GridSpec2D,
    obstacle: OM.ObstacleMapState,
    robot_xy: torch.Tensor,  # (2,)
    heading: torch.Tensor,  # ()
    last_frontier: torch.Tensor,  # (2,)
    last_value: torch.Tensor,  # ()
    acyclic: AC.AcyclicState,
) -> Decision:
    """V2 scoring of the obstacle map's frontiers, the frontier choice and
    the greedy action (STOP when there is no frontier)."""
    frontiers, valid = obstacle.frontiers_xy, obstacle.frontiers_valid
    radius_px = int(0.5 * spec.pixels_per_meter)
    wvals = VM.waypoint_values(state, spec, frontiers, valid, radius_px=radius_px)
    choice = select_best_frontier(
        frontiers, valid, wvals[:, 0], robot_xy, last_frontier, last_value, acyclic
    )
    rho, theta = rho_theta(robot_xy, heading, choice.frontier)
    action = torch.where(choice.any_valid, greedy_action(theta), STOP).to(torch.int32)
    return Decision(choice, wvals, rho, theta, action)
