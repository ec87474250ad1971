"""The map half of the ITM policy step.

Counterpart of the parts of ``vlfm_tpu/policy/itm.py:step`` that need no
PointNav: the obstacle-map update with its frontiers (itm.py:124-140),
fusing ITM cosines into the value map (itm.py:142-156), the object map's
detections, eviction and target (itm.py:160-185),
scoring the frontiers by the value-map median within 0.5 m (V2,
itm.py:212-225), the frontier choice, and the greedy rho-theta controller
(itm.py:253-261).

``update_obstacles``, ``fuse_view``, ``update_objects`` and ``decide`` have
no namesakes in the JAX module: they are the parts of ``step`` that the
port has so far, and they go when ``step`` itself is ported (ROADMAP Queue
1 item 3), which then owns the maps and the decision. Each works on a batch
of B lanes (episodes) at once, as JAX's vmapped ``step`` does; one episode
is B = 1.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from vlfm_tpu_torch.config import VLFMConfig
from vlfm_tpu_torch.mapping import object_map as OBJ
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
    waypoint_values: torch.Tensor  # (B, F, C)
    rho: torch.Tensor  # (B,)
    theta: torch.Tensor  # (B,)
    action: torch.Tensor  # (B,) int32


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
    depth: torch.Tensor,  # (B, H, W) normalized [0, 1]
    tf_camera_to_episodic: torch.Tensor,  # (B, 4, 4)
    steps: int | torch.Tensor,  # (B,) the policy's step counts before this step, or one for all
) -> OM.ObstacleMapState:
    """One obstacle-map update per lane with the policy's camera and map
    settings; every 8th step of a lane prunes its explored area from the
    agent alone."""
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
    cosines: torch.Tensor,  # (B, C)
    depth: torch.Tensor,  # (B, H, W) normalized [0, 1]
    tf_camera_to_episodic: torch.Tensor,  # (B, 4, 4)
    explored: torch.Tensor,  # (B, S, S) bool, the obstacle map's explored area after this view
) -> VM.ValueMapState:
    """One value-map update per lane with the policy's camera and fusion settings;
    with ``cfg.sync_explored_areas`` the value map is cut to ``explored``
    (vlfm_tpu/policy/itm.py:157)."""
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
        explored=explored if cfg.sync_explored_areas else None,
    )


def update_objects(
    objmap: OBJ.ObjectMapState,
    spec: GridSpec2D,
    cfg: VLFMConfig,
    depth: torch.Tensor,  # (B, H, W) normalized [0, 1]
    masks: torch.Tensor,  # (B, K, H, W) bool segmentation masks
    valid: torch.Tensor,  # (B, K) bool
    tf_camera_to_episodic: torch.Tensor,  # (B, 4, 4)
    robot_xy: torch.Tensor,  # (B, 2)
    keys: torch.Tensor,  # (B, 2) threefry keys, fold_in(PRNGKey(seed), step) per lane
):
    """Each lane's detections into its object map, the eviction of suspect
    points the camera sees again, and the target (vlfm_tpu/policy/itm.py:
    160-185). Returns ((B,) target_detected, (B, 2) goal, new object map)."""
    del spec  # the object map keeps world points, not grid cells
    cam = cfg.camera
    objmap = OBJ.update_batch(
        objmap, keys, depth, masks, valid, tf_camera_to_episodic, cam.min_depth, cam.max_depth, cam.fx, cam.fy,
        erosion_size=cfg.object_map_erosion_size, use_dbscan=cfg.use_object_map_dbscan,
    )
    objmap = OBJ.update_explored(objmap, tf_camera_to_episodic, cam.max_depth, cam.object_map_cone_fov)
    target_detected = OBJ.has_object(objmap)
    goal, objmap = OBJ.get_best_object(objmap, robot_xy, use_dbscan=cfg.use_object_map_dbscan)
    return target_detected, goal, objmap


def decide(
    state: VM.ValueMapState,
    spec: GridSpec2D,
    obstacle: OM.ObstacleMapState,
    robot_xy: torch.Tensor,  # (B, 2)
    heading: torch.Tensor,  # (B,)
    last_frontier: torch.Tensor,  # (B, 2)
    last_value: torch.Tensor,  # (B,)
    acyclic: AC.AcyclicState,
) -> Decision:
    """V2 scoring of each lane's obstacle-map frontiers, the frontier choice
    and the greedy action (STOP when a lane has no frontier)."""
    frontiers, valid = obstacle.frontiers_xy, obstacle.frontiers_valid
    radius_px = int(0.5 * spec.pixels_per_meter)
    wvals = VM.waypoint_values(state, spec, frontiers, valid, radius_px=radius_px)
    choice = select_best_frontier(
        frontiers, valid, wvals[..., 0], robot_xy, last_frontier, last_value, acyclic
    )
    rho, theta = rho_theta(robot_xy, heading, choice.frontier)
    action = torch.where(choice.any_valid, greedy_action(theta), STOP).to(torch.int32)
    return Decision(choice, wvals, rho, theta, action)
