"""The VLFM ITM policy step for a batch of episodes.

Counterpart of ``vlfm_tpu/policy/itm.py`` (reference:
BaseObjectNavPolicy.act, base_objectnav_policy.py:106-352;
BaseITMPolicy/_ITMPolicyV2/V3, itm_policy.py:26-316; HabitatMixin's
360-degree spin and STOP on the map edge, habitat_policies.py:121-153).

One ``step`` takes B lanes (episodes) at once, each with its observation,
ITM cosines per prompt channel, detection masks and threefry key, and
advances every lane's state: the obstacle, value and object maps, the
frontier choice with its acyclic memory, the V1 frontier cache and the
PointNav recurrence. Where JAX vmaps a per-episode step, every state here
carries a leading lane axis, and each per-lane choice is a ``torch.where``
over the lanes; one episode is B = 1. On the card nothing in ``step`` reads
a device value on the host (the obstacle map's sweep loops run as kernels),
so a CUDA graph can hold it (``runner/full_stack.StepGraphs``); on the CPU
the sweep loops' checks read the device.

Mode machine (base_objectnav_policy.py:130-138): INITIALIZE (spin
``num_init_turns`` x TURN_LEFT) -> EXPLORE (best frontier) -> NAVIGATE
(approach the detected target; STOP within ``pointnav_stop_radius``).
Frontier scoring: ``v1`` the cosine cached at a frontier's first sight,
``v2`` the value-map median within 0.5 m, ``v3`` V2 with the exploration
channel below ``exploration_thresh``, ``fbe`` the nearest frontier. The
controller is the greedy rho-theta rule (``pointnav="greedy"``) or a
``PointNavPolicy``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from vlfm_tpu_torch.config import VLFMConfig
from vlfm_tpu_torch.device import default_device
from vlfm_tpu_torch.mapping import frontier_map as FM
from vlfm_tpu_torch.mapping import object_map as OBJ
from vlfm_tpu_torch.mapping import obstacle_map as OM
from vlfm_tpu_torch.mapping import value_map as VM
from vlfm_tpu_torch.mapping.grid import GridSpec2D
from vlfm_tpu_torch.models.pointnav import PointNavPolicy, PointNavState, initial_state, reset_episodes
from vlfm_tpu_torch.models.precision import exact_f32
from vlfm_tpu_torch.policy import acyclic as AC
from vlfm_tpu_torch.policy.frontier_selection import reduce_values_v3, select_best_frontier
from vlfm_tpu_torch.utils.geometry import rho_theta
from vlfm_tpu_torch.utils.img import resize_area
from vlfm_tpu_torch.utils.profiling import span

STOP, MOVE_FORWARD, TURN_LEFT, TURN_RIGHT = 0, 1, 2, 3  # habitat_policies.py:54-58
MODE_INITIALIZE, MODE_EXPLORE, MODE_NAVIGATE = 0, 1, 2
VERSIONS = ("v1", "v2", "v3", "fbe")
EDGE_MARGIN = 8  # pixels: STOP this close to the map's edge (base_objectnav_policy.py:158-162)

FUSION_TYPES = {
    "default": VM.FUSION_DEFAULT,
    "replace": VM.FUSION_REPLACE,
    "equal_weighting": VM.FUSION_EQUAL_WEIGHTING,
}


class Observation(NamedTuple):
    depth: torch.Tensor  # (B, H, W) normalized [0, 1]
    tf_camera_to_episodic: torch.Tensor  # (B, 4, 4)
    robot_xy: torch.Tensor  # (B, 2)
    robot_heading: torch.Tensor  # (B,)


class PolicyState(NamedTuple):
    steps: torch.Tensor  # (B,) int32
    last_goal: torch.Tensor  # (B, 2) zeros sentinel
    called_stop: torch.Tensor  # (B,) bool
    last_value: torch.Tensor  # (B,)
    last_frontier: torch.Tensor  # (B, 2)
    pointnav: PointNavState  # h, c (L, B, 512); prev_action, not_done (B, 1)
    obstacle: OM.ObstacleMapState
    value: VM.ValueMapState
    objmap: OBJ.ObjectMapState
    acyclic: AC.AcyclicState
    frontier_cache: FM.FrontierMapState  # V1 only (itm_policy.py:219-247)


class StepInfo(NamedTuple):
    mode: torch.Tensor  # (B,) int32
    action: torch.Tensor  # (B,) int32
    rho: torch.Tensor  # (B,)
    theta: torch.Tensor  # (B,)
    best_value: torch.Tensor  # (B,)
    goal: torch.Tensor  # (B, 2)
    num_frontiers: torch.Tensor  # (B,)
    target_detected: torch.Tensor  # (B,) bool
    stop_called: torch.Tensor  # (B,) bool


def create_state(spec: GridSpec2D, cfg: VLFMConfig, *, batch: int = 1,
                 device: torch.device | str = default_device()) -> PolicyState:
    """B fresh episodes."""
    return PolicyState(
        steps=torch.zeros(batch, dtype=torch.int32, device=device),
        last_goal=torch.zeros((batch, 2), dtype=torch.float32, device=device),
        called_stop=torch.zeros(batch, dtype=torch.bool, device=device),
        last_value=torch.full((batch,), -math.inf, dtype=torch.float32, device=device),
        last_frontier=torch.zeros((batch, 2), dtype=torch.float32, device=device),
        pointnav=initial_state(batch, device=device),
        obstacle=OM.create(spec, cfg.max_frontiers, batch=batch, device=device),
        value=VM.create(spec, cfg.value_channels, batch=batch, device=device),
        objmap=OBJ.create(cfg.object_map_slots, cfg.object_map_points_per_slot, batch=batch, device=device),
        acyclic=AC.create(batch=batch, device=device),
        frontier_cache=FM.create(cfg.max_frontiers * 2, batch=batch, device=device),
    )


def _where_lanes(lanes: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """``new`` on the lanes set in the (B,) bool ``lanes`` (axis 0), else ``old``."""
    return torch.where(lanes.reshape(-1, *([1] * (old.ndim - 1))), new, old)


def reset_lanes(state: PolicyState, lanes: torch.Tensor) -> PolicyState:
    """The state with the lanes set in the (B,) bool ``lanes`` started anew
    and the others as they were: per-lane ``torch.where`` against a fresh
    episode (the obstacle and value maps are cleared in place)."""
    fresh_value = torch.full_like(state.last_value, -math.inf)
    return PolicyState(
        steps=_where_lanes(lanes, torch.zeros_like(state.steps), state.steps),
        last_goal=_where_lanes(lanes, torch.zeros_like(state.last_goal), state.last_goal),
        called_stop=state.called_stop & ~lanes,
        last_value=_where_lanes(lanes, fresh_value, state.last_value),
        last_frontier=_where_lanes(lanes, torch.zeros_like(state.last_frontier), state.last_frontier),
        pointnav=reset_episodes(state.pointnav, lanes),
        obstacle=OM.reset(state.obstacle, lanes),
        value=VM.reset(state.value, lanes),
        objmap=OBJ.reset(state.objmap, lanes),
        acyclic=AC.AcyclicState(*(_where_lanes(lanes, torch.zeros_like(t), t) for t in state.acyclic)),
        frontier_cache=FM.reset(state.frontier_cache, lanes),
    )


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
    settings (habitat_policies.py:191-203); every 8th step of a lane prunes
    its explored area from the agent alone."""
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


def update_objects(
    objmap: OBJ.ObjectMapState,
    spec: GridSpec2D,
    cfg: VLFMConfig,
    depth: torch.Tensor,  # (B, H, W) normalized [0, 1]
    masks: torch.Tensor,  # (B, K, H, W) bool segmentation masks
    valid: torch.Tensor,  # (B, K) bool
    tf_camera_to_episodic: torch.Tensor,  # (B, 4, 4)
    robot_xy: torch.Tensor,  # (B, 2)
    keys: torch.Tensor,  # (B, 2) threefry keys
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


def _frontier_values(version, cache: FM.FrontierMapState, obstacle, value, spec, cfg, cosines, robot_xy):
    """(B, F) per-frontier values and the (possibly updated) V1 cache."""
    frontiers, valid = obstacle.frontiers_xy, obstacle.frontiers_valid
    if version == "fbe":
        # The nearest frontier wins; the value map still updates
        # (habitat_policies.py:240-245).
        dist = torch.linalg.vector_norm(frontiers - robot_xy[:, None], dim=-1)
        return torch.where(valid, -dist, -torch.inf), cache
    if version == "v1":
        cache = FM.update(cache, frontiers, valid, cosines[:, 0])
        m = FM.matches(cache.positions, cache.valid, frontiers, valid)  # (B, N, F)
        cached = torch.gather(cache.cosines, 1, torch.argmax(m.to(torch.int32), dim=1))
        return torch.where(m.any(dim=1), cached, -torch.inf), cache
    wvals = VM.waypoint_values(value, spec, frontiers, valid, radius_px=int(0.5 * spec.pixels_per_meter))
    if version == "v3":
        return reduce_values_v3(wvals, valid, cfg.exploration_thresh), cache
    return wvals[..., 0], cache


def step(
    state: PolicyState,
    obs: Observation,
    cosines: torch.Tensor,  # (B, C) BLIP2-ITM scores per prompt channel
    det_masks: torch.Tensor,  # (B, K, H, W) bool segmentation masks
    det_valid: torch.Tensor,  # (B, K) bool
    keys: torch.Tensor,  # (B, 2) threefry keys
    object_depth: torch.Tensor | None = None,  # (B, H, W); monocular-depth fallback
    *,
    pointnav: PointNavPolicy | str,
    spec: GridSpec2D,
    cfg: VLFMConfig,
    version: str = "v2",
):
    """One decision step for every lane: (action (B,) int32, StepInfo, new
    state). The obstacle and value maps of ``state`` are updated in place
    and returned in the new state. The call is a ``vlfm.step`` span, with
    ``vlfm.map.obstacle``, ``vlfm.map.value``, ``vlfm.map.object``,
    ``vlfm.frontier`` and (a ``PointNavPolicy``) ``vlfm.pointnav`` inside."""
    with span("vlfm.step"):
        if version not in VERSIONS:
            raise ValueError(f"version must be one of {VERSIONS}, not {version!r}")
        if isinstance(pointnav, str) and pointnav != "greedy":
            raise ValueError(f"pointnav must be 'greedy' or a PointNavPolicy, not {pointnav!r}")
        cam = cfg.camera
        tf, robot_xy = obs.tf_camera_to_episodic, obs.robot_xy
        # The object map may take an inferred depth (base_objectnav_policy.py:
        # 314-318); the obstacle and value maps keep the sensor's.
        if object_depth is None:
            object_depth = obs.depth

        rc = spec.xy_to_px(robot_xy)
        in_bounds = ((rc >= EDGE_MARGIN) & (rc < spec.size - EDGE_MARGIN)).all(dim=-1)

        with span("vlfm.map.obstacle"):
            obstacle = update_obstacles(state.obstacle, spec, cfg, obs.depth, tf, state.steps)
        with span("vlfm.map.value"):
            value = VM.update(
                state.value, spec, cosines, obs.depth, tf, cam.min_depth, cam.max_depth, cam.hfov,
                use_max_confidence=cfg.use_max_confidence, fusion_type=FUSION_TYPES[cfg.map_fusion_type],
                explored=obstacle.explored if cfg.sync_explored_areas else None,
            )
        with span("vlfm.map.object"):
            target_detected, obj_goal, objmap = update_objects(
                state.objmap, spec, cfg, object_depth, det_masks, det_valid, tf, robot_xy, keys)

        with span("vlfm.frontier"):
            fvalues, frontier_cache = _frontier_values(version, state.frontier_cache, obstacle, value, spec, cfg,
                                                       cosines, robot_xy)
            choice = select_best_frontier(obstacle.frontiers_xy, obstacle.frontiers_valid, fvalues, robot_xy,
                                          state.last_frontier, state.last_value, state.acyclic)

        # --- mode dispatch ---------------------------------------------------
        initializing = state.steps < cfg.num_init_turns
        navigate = target_detected & ~initializing
        explore = ~initializing & ~navigate
        mode = torch.where(initializing, MODE_INITIALIZE,
                           torch.where(navigate, MODE_NAVIGATE, MODE_EXPLORE)).to(torch.int32)
        goal = torch.where(navigate[:, None], obj_goal, choice.frontier)

        # --- pointnav (base_objectnav_policy.py:243-279) ---------------------
        goal_changed = (goal != state.last_goal).any(dim=-1)
        big_change = torch.linalg.vector_norm(goal - state.last_goal, dim=-1) > 0.1
        # not_done False makes act() zero the recurrence and the previous action.
        not_done = state.pointnav.not_done & (~big_change & (state.steps != 0))[:, None]
        pn = state.pointnav._replace(not_done=not_done)
        last_goal = torch.where(goal_changed[:, None], goal, state.last_goal)

        rho, theta = rho_theta(robot_xy, obs.robot_heading, goal)
        if isinstance(pointnav, str):
            pn_action = greedy_action(theta)
        else:
            with span("vlfm.pointnav"):
                with exact_f32(obs.depth.device):  # PointNav's input stays f32, as in JAX
                    nav_depth = resize_area(obs.depth, tuple(cfg.depth_image_shape))
                pn_action, pn = pointnav.act(nav_depth, torch.stack([rho, theta], dim=-1), pn, deterministic=True)
                pn_action = pn_action[:, 0].to(torch.int32)

        reached = navigate & (rho < cfg.pointnav_stop_radius)
        no_frontier = explore & ~choice.any_valid  # itm_policy.py:66-68 -> STOP
        action = torch.where(
            ~in_bounds, STOP,
            torch.where(initializing, TURN_LEFT, torch.where(reached | no_frontier, STOP, pn_action)),
        ).to(torch.int32)
        called_stop = state.called_stop | reached

        # The frontier's stickiness and the acyclic memory move only on lanes
        # that explored this step.
        new_state = PolicyState(
            steps=state.steps + 1,
            last_goal=last_goal,
            called_stop=called_stop,
            last_value=torch.where(explore, choice.last_value, state.last_value),
            last_frontier=torch.where(explore[:, None], choice.last_frontier, state.last_frontier),
            pointnav=pn,
            obstacle=obstacle,
            value=value,
            objmap=objmap,
            acyclic=AC.AcyclicState(*(_where_lanes(explore, new, old)
                                      for new, old in zip(choice.acyclic, state.acyclic))),
            frontier_cache=frontier_cache,
        )
        info = StepInfo(
            mode=mode,
            action=action,
            rho=rho,
            theta=theta,
            best_value=choice.value,
            goal=goal,
            num_frontiers=obstacle.frontiers_valid.sum(dim=-1),
            target_detected=target_detected,
            stop_called=called_stop,
        )
        return action, info, new_state
