"""The reality (Spot) policy: multi-camera obstacle fusion, an arm-yaw
start and continuous (angular, linear) actions.

Counterpart of ``vlfm_tpu/policy/reality.py`` (reference:
vlfm/policy/reality_policies.py, RealityMixin and RealityITMPolicyV2):

- the start is 8 gripper-camera arm yaws, -90..+90 deg then 0
  (reality_policies.py:16,100-102), with the base still (:79-86);
- each step fuses the body depth cameras into the obstacle map with
  ``explore=False``, then makes one hand-camera update with
  ``explore=True`` and ``update_obstacles=False`` (:104-139); the
  environment sends all 5 body cameras for its first 10 steps, then the
  front pair (objectnav_env.py:186-190), as a fixed 5-slot stack with
  validity flags;
- the value map is masked by the explored area (sync_explored_areas,
  :39);
- actions are continuous: the mean of PointNav's Gaussian head, angular
  then linear (:69-89), with rho and theta passed through; STOP is (0, 0)
  and the stop flag (:28);
- the gripper camera has no depth: the host wrapper infers the object
  map's depth when a detection is valid (base_objectnav_policy.py:314-318)
  and passes it as ``object_depth``; DBSCAN is off on the robot (:43).

The state is the ITM policy's, batch-first with one lane, B = 1, as
``adapters/habitat.py``'s agent keeps it. The body cameras' intrinsics,
fovs, ranges and validity are host values (each rounded to float32, as
the JAX package stacks them), so an empty camera slot is skipped in Python
and costs no device read. The obstacle and value maps are updated in place.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from vlfm_tpu_torch.config import VLFMConfig
from vlfm_tpu_torch.device import default_device
from vlfm_tpu_torch.mapping import object_map as OBJ
from vlfm_tpu_torch.mapping import obstacle_map as OM
from vlfm_tpu_torch.mapping import value_map as VM
from vlfm_tpu_torch.mapping.grid import GridSpec2D
from vlfm_tpu_torch.models.pointnav import initial_state
from vlfm_tpu_torch.models.precision import exact_f32
from vlfm_tpu_torch.ops import threefry
from vlfm_tpu_torch.policy import acyclic as AC
from vlfm_tpu_torch.policy import itm
from vlfm_tpu_torch.policy.frontier_selection import reduce_values_v3, select_best_frontier
from vlfm_tpu_torch.utils.geometry import rho_theta
from vlfm_tpu_torch.utils.img import resize_area
from vlfm_tpu_torch.utils.profiling import span

# reality_policies.py:16
INITIAL_ARM_YAWS = np.deg2rad([-90, -60, -30, 0, 30, 60, 90, 0]).astype(np.float32)
NUM_INIT_YAWS = len(INITIAL_ARM_YAWS)
MAX_BODY_CAMS = 5


class BodyCams(NamedTuple):
    """The fixed 5-slot stack of body depth cameras (padded, with flags)."""

    depth: torch.Tensor  # (5, H, W) normalized [0, 1]
    tf: torch.Tensor  # (5, 4, 4) camera -> episodic
    fx: Tuple[float, ...]  # (5,) host floats, float32 values
    fy: Tuple[float, ...]
    fov: Tuple[float, ...]  # top-down fov (radians)
    max_depth: Tuple[float, ...]
    valid: Tuple[bool, ...]


class HandCam(NamedTuple):
    tf: torch.Tensor  # (1, 4, 4) camera -> episodic
    fov: float  # host floats, float32 values
    fx: float
    fy: float
    max_depth: float


class RealityAction(NamedTuple):
    angular: torch.Tensor  # (1,)
    linear: torch.Tensor  # (1,)
    arm_yaw: torch.Tensor  # (1,) -1.0 once the start is over
    stop: torch.Tensor  # (1,) bool
    rho: torch.Tensor  # (1,)
    theta: torch.Tensor  # (1,)


def _f32(x) -> float:
    """A host scalar rounded to float32, as the JAX package stacks it."""
    return float(np.float32(x))


def create_state(spec: GridSpec2D, cfg: VLFMConfig, *,
                 device: torch.device | str = default_device()) -> itm.PolicyState:
    """One fresh episode (B = 1) with the continuous PointNav recurrence
    (``prev_action`` is (1, 2))."""
    state = itm.create_state(spec, cfg, device=device)
    return state._replace(pointnav=initial_state(1, discrete=False, device=device))


def fuse_cameras(obstacle: OM.ObstacleMapState, spec: GridSpec2D, cfg: VLFMConfig, body: BodyCams,
                 hand: HandCam, steps: torch.Tensor) -> OM.ObstacleMapState:
    """The obstacle map's part of a step (reality_policies.py:115-139):
    every valid body camera with ``explore=False``, then the hand camera's
    explore-only update, which prunes the explored area from the agent
    alone on every 8th step (``steps`` (1,), the count before this step)."""
    for i in range(MAX_BODY_CAMS):
        if not body.valid[i]:  # a host flag: no device read
            continue
        obstacle = OM.update(
            obstacle, spec, body.depth[i:i + 1], body.tf[i:i + 1],
            0.0, body.max_depth[i], body.fx[i], body.fy[i], body.fov[i],
            cfg.min_obstacle_height, cfg.max_obstacle_height, cfg.obstacle_map_area_threshold,
            agent_radius=cfg.agent_radius,
            explore=False,
        )
    return OM.update(
        obstacle, spec,
        body.depth[:1],  # not read with update_obstacles=False
        hand.tf, 0.0, hand.max_depth, hand.fx, hand.fy, hand.fov,
        cfg.min_obstacle_height, cfg.max_obstacle_height, cfg.obstacle_map_area_threshold,
        full_prune=(steps % 8) == 0,
        agent_radius=cfg.agent_radius,
        explore=True,
        update_obstacles=False,
        max_frontier_cells=cfg.max_frontier_cells,
        max_frontiers=cfg.max_frontiers,
    )


def reality_step(
    state: itm.PolicyState,
    body: BodyCams,
    hand: HandCam,
    cosines: torch.Tensor,  # (1, C) ITM scores of the hand RGB
    value_depth: torch.Tensor,  # (1, Hv, Wv); all ones on the robot (see the module's docstring)
    object_depth: torch.Tensor,  # (1, Ho, Wo); inferred when the hand depth is all ones
    det_masks: torch.Tensor,  # (1, K, Ho, Wo) bool
    det_valid: torch.Tensor,  # (1, K) bool
    nav_depth: torch.Tensor,  # (1, Hn, Wn) the front pair's depth for PointNav
    robot_xy: torch.Tensor,  # (1, 2)
    robot_heading: torch.Tensor,  # (1,)
    rng: torch.Tensor,  # (1, 2) threefry key
    *,
    pointnav,
    spec: GridSpec2D,
    cfg: VLFMConfig,
    version: str = "v2",
):
    """One robot step: (RealityAction, new state)."""
    if version not in ("v2", "v3"):
        raise ValueError(f"version must be 'v2' or 'v3', not {version!r}")
    obstacle = fuse_cameras(state.obstacle, spec, cfg, body, hand, state.steps)

    # The value map, masked by the explored area (reality_policies.py:39).
    value = VM.update(
        state.value, spec, cosines, value_depth, hand.tf, 0.0, hand.max_depth, hand.fov,
        use_max_confidence=cfg.use_max_confidence,
        fusion_type=itm.FUSION_TYPES[cfg.map_fusion_type],
        explored=obstacle.explored,
    )

    # The object map from the hand camera, without DBSCAN.
    objmap = OBJ.update_batch(
        state.objmap, rng, object_depth, det_masks, det_valid, hand.tf, 0.0, hand.max_depth, hand.fx, hand.fy,
        erosion_size=cfg.object_map_erosion_size, use_dbscan=False,
    )
    objmap = OBJ.update_explored(objmap, hand.tf, hand.max_depth, hand.fov)
    target_detected = OBJ.has_object(objmap)
    obj_goal, objmap = OBJ.get_best_object(objmap, robot_xy, use_dbscan=False)

    # Frontier scoring, V2 or V3.
    wvals = VM.waypoint_values(value, spec, obstacle.frontiers_xy, obstacle.frontiers_valid,
                               radius_px=int(0.5 * spec.pixels_per_meter))
    if version == "v3":
        fvalues = reduce_values_v3(wvals, obstacle.frontiers_valid, cfg.exploration_thresh)
    else:
        fvalues = wvals[..., 0]
    choice = select_best_frontier(obstacle.frontiers_xy, obstacle.frontiers_valid, fvalues, robot_xy,
                                  state.last_frontier, state.last_value, state.acyclic)

    # The mode machine: 8 arm yaws, then explore or navigate.
    initializing = state.steps < NUM_INIT_YAWS
    navigate = target_detected & ~initializing
    explore = ~initializing & ~navigate
    goal = torch.where(navigate[:, None], obj_goal, choice.frontier)

    goal_changed = (goal != state.last_goal).any(dim=-1)
    big_change = torch.linalg.vector_norm(goal - state.last_goal, dim=-1) > 0.1
    not_done = state.pointnav.not_done & (~big_change & (state.steps != 0))[:, None]
    pn = state.pointnav._replace(not_done=not_done)
    last_goal = torch.where(goal_changed[:, None], goal, state.last_goal)

    rho, theta = rho_theta(robot_xy, robot_heading, goal)
    if isinstance(pointnav, str):
        if pointnav != "greedy":
            raise ValueError(f"pointnav must be 'greedy' or a PointNavPolicy, not {pointnav!r}")
        # A proportional controller for tests without trained weights.
        pn_action = torch.stack([theta.clamp(-1.0, 1.0), torch.where(theta.abs() < 0.4, 0.3, 0.0)], dim=-1)
    else:
        with exact_f32(nav_depth.device):  # PointNav's input stays f32, as in JAX
            nd = resize_area(nav_depth, tuple(cfg.depth_image_shape))
        pn_action, pn = pointnav.act(nd, torch.stack([rho, theta], dim=-1), pn, deterministic=True)

    reached = navigate & (rho < cfg.pointnav_stop_radius)
    no_frontier = explore & ~choice.any_valid
    stop = reached | no_frontier

    yaws = torch.as_tensor(INITIAL_ARM_YAWS, device=rho.device)
    arm_yaw = torch.where(initializing, yaws[state.steps.clamp(0, NUM_INIT_YAWS - 1).long()], -1.0)
    still = initializing | stop
    angular = torch.where(still, 0.0, pn_action[:, 0])
    linear = torch.where(still, 0.0, pn_action[:, 1])

    new_state = itm.PolicyState(
        steps=state.steps + 1,
        last_goal=last_goal,
        called_stop=state.called_stop | reached,
        last_value=torch.where(explore, choice.last_value, state.last_value),
        last_frontier=torch.where(explore[:, None], choice.last_frontier, state.last_frontier),
        pointnav=pn,
        obstacle=obstacle,
        value=value,
        objmap=objmap,
        acyclic=AC.AcyclicState(*(itm._where_lanes(explore, new, old)
                                  for new, old in zip(choice.acyclic, state.acyclic))),
        frontier_cache=state.frontier_cache,
    )
    action = RealityAction(angular=angular, linear=linear, arm_yaw=arm_yaw, stop=stop, rho=rho, theta=theta)
    return action, new_state


class RealityITMPolicyV2:
    """Host wrapper: ``ObjectNavEnv`` observation dicts in, Spot action
    dicts out.

    Mirrors RealityMixin.act/get_action (reality_policies.py:52-96) and
    returns {"angular", "linear", "arm_yaw", "rho_theta", "stop"}. The
    perception hooks are plain callables, so the same wrapper serves tiny
    test models and full-width ones: ``score_fn(rgb)`` -> (C,) cosines,
    ``detect_fn(rgb)`` -> (masks (K, H, W), valid (K,)),
    ``infer_depth_fn(rgb, min_depth, max_depth)`` -> (H, W) normalized
    depth, each returning numpy arrays or tensors. ``pointnav`` is
    ``"greedy"`` or a continuous ``PointNavPolicy``. The key stream is
    JAX's: ``PRNGKey(seed)``, split once per ``get_action``. After each
    call ``last_inputs`` holds the step's inputs, ``reality_step``'s
    arguments after the state."""

    def __init__(
        self,
        spec: GridSpec2D,
        cfg: VLFMConfig,
        *,
        pointnav="greedy",
        score_fn=None,
        detect_fn=None,
        infer_depth_fn=None,
        version: str = "v2",
        seed: int = 0,
        device: torch.device | str = default_device(),
    ):
        self.spec, self.cfg = spec, cfg
        self.pointnav, self.version = pointnav, version
        self.score_fn = score_fn or (lambda rgb: np.full(cfg.value_channels, 0.5, np.float32))
        self.detect_fn = detect_fn
        self.infer_depth_fn = infer_depth_fn
        self.device = torch.device(device)
        self.rng = threefry.PRNGKey(seed, device=self.device)
        self.acts = 0
        self.reset()

    def reset(self) -> None:
        self.state = create_state(self.spec, self.cfg, device=self.device)

    def _lane(self, x, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(dtype)[None]

    def get_action(self, obs: dict) -> dict:
        """One decision: the action dict, from one read back. The call is a
        ``vlfm.act`` span whose ``decision`` counts the policy's acts."""
        self.acts += 1
        with span("vlfm.act", decision=self.acts - 1):
            cfg, dev = self.cfg, self.device
            k = cfg.max_detections_per_frame
            rgb = obs["rgb"]
            h, w = rgb.shape[:2]

            # Detections, and monocular depth for the object map.
            masks = np.zeros((k, h, w), bool)
            valid = np.zeros(k, bool)
            if self.detect_fn is not None:
                masks, valid = self.detect_fn(rgb)
            hand_depth = torch.ones((1, h, w), dtype=torch.float32, device=dev)  # an RGB-only gripper camera
            object_depth = hand_depth
            if self.infer_depth_fn is not None and bool(torch.as_tensor(valid).any()):
                object_depth = self._lane(self.infer_depth_fn(rgb, 0.0, obs["hand_max_depth"]), torch.float32)

            # The fixed 5-slot body-camera stack.
            ods = obs["obstacle_depths"]
            if not 0 < len(ods) <= MAX_BODY_CAMS:
                raise ValueError(f"{len(ods)} body cameras; the stack holds 1 to {MAX_BODY_CAMS}")
            depth5 = np.zeros((MAX_BODY_CAMS, *ods[0]["depth"].shape), np.float32)
            tf5 = np.tile(np.eye(4, dtype=np.float32), (MAX_BODY_CAMS, 1, 1))
            pad = MAX_BODY_CAMS - len(ods)
            for i, od in enumerate(ods):
                depth5[i], tf5[i] = od["depth"], od["tf"]
            body = BodyCams(
                depth=torch.from_numpy(depth5).to(dev), tf=torch.from_numpy(tf5).to(dev),
                fx=tuple(_f32(od["fx"]) for od in ods) + (1.0,) * pad,
                fy=tuple(_f32(od["fy"]) for od in ods) + (1.0,) * pad,
                fov=tuple(_f32(od["topdown_fov"]) for od in ods) + (1.0,) * pad,
                max_depth=tuple(_f32(od["max_depth"]) for od in ods) + (1.0,) * pad,
                valid=(True,) * len(ods) + (False,) * pad,
            )
            hand = HandCam(tf=self._lane(np.asarray(obs["hand_tf"], np.float32), torch.float32),
                           fov=_f32(obs["hand_fov"]), fx=_f32(obs["hand_fx"]), fy=_f32(obs["hand_fy"]),
                           max_depth=_f32(obs["hand_max_depth"]))
            cos = self._lane(self.score_fn(rgb), torch.float32)[:, : cfg.value_channels]

            self.rng, sub = threefry.split(self.rng)
            self.last_inputs = (
                body, hand, cos, hand_depth, object_depth,
                self._lane(masks, torch.bool), self._lane(valid, torch.bool),
                self._lane(np.asarray(obs["nav_depth"], np.float32), torch.float32),
                self._lane(np.asarray(obs["robot_xy"], np.float32), torch.float32),
                self._lane(np.float32(obs["heading"]), torch.float32),
                sub[None],
            )
            action, self.state = reality_step(self.state, *self.last_inputs, pointnav=self.pointnav, spec=self.spec,
                                              cfg=cfg, version=self.version)
            # One read back: angular, linear, arm_yaw, stop, rho, theta.
            out = torch.stack([action.angular, action.linear, action.arm_yaw, action.stop.to(torch.float32),
                               action.rho, action.theta], dim=-1)[0].cpu().numpy()
            return {
                "angular": float(out[0]),
                "linear": float(out[1]),
                "arm_yaw": float(out[2]),
                "stop": bool(out[3]),
                "rho_theta": (float(out[4]), float(out[5])),
            }
