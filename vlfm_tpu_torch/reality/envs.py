"""Real-robot environments (gym-like reset/step; host code, numpy only).

Counterpart of ``vlfm_tpu/reality/envs.py`` (reference:
vlfm/reality/pointnav_env.py and objectnav_env.py): an episodic frame
anchored at the boot pose, discrete or continuous (angular, linear)
actions sent as base-velocity commands, arm-yaw actions sent to the arm,
the body depth cameras for the obstacle map (all five for the first
``all_cams_until_step`` steps, then the front pair), and depth in mm
normalised to [0, 1]. The observations equal the JAX package's bit for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

from vlfm_tpu_torch.reality.robots import CAM_TO_XYZ, BaseRobot
from vlfm_tpu_torch.utils.geometry import get_fov

STOP, MOVE_FORWARD, TURN_LEFT, TURN_RIGHT = 0, 1, 2, 3

BODY_DEPTH_CAMERAS = [
    "frontleft_depth",
    "frontright_depth",
    "left_depth",
    "right_depth",
    "back_depth",
]


@dataclass
class RealityEnvConfig:
    max_body_cam_depth: float = 3.5
    max_gripper_cam_depth: float = 5.0
    forward_step: float = 0.25
    turn_deg: float = 30.0
    time_step: float = 0.5
    # The first N steps fuse all body cameras, later ones only the front
    # pair (objectnav_env.py:186-190).
    all_cams_until_step: int = 10


class PointNavEnv:
    """Drive to a (rho, theta) goal with discrete or continuous commands."""

    def __init__(self, robot: BaseRobot, cfg: Optional[RealityEnvConfig] = None):
        self.robot = robot
        self.cfg = cfg or RealityEnvConfig()
        self.goal = np.zeros(2, np.float32)

    def reset(self, goal_xy: np.ndarray, relative: bool = True) -> Dict[str, Any]:
        """With ``relative=True`` (the reference's default) the goal is in
        the ROBOT frame and is stored in the global one
        (reality/pointnav_env.py:45-52)."""
        goal = np.asarray(goal_xy, np.float32)
        xy, yaw = self.robot.xy_yaw
        if relative:
            c, s = np.cos(yaw), np.sin(yaw)
            goal = np.asarray(
                [xy[0] + c * goal[0] - s * goal[1],
                 xy[1] + s * goal[0] + c * goal[1]], np.float32
            )
        self.goal = goal
        self._boot = (xy.copy(), yaw)
        return self.observe()

    def _to_episodic(self, xy: np.ndarray, yaw: float):
        bxy, byaw = self._boot
        d = xy - bxy
        c, s = math.cos(-byaw), math.sin(-byaw)
        return np.array([c * d[0] - s * d[1], s * d[0] + c * d[1]], np.float32), yaw - byaw

    def _drive(self, action) -> None:
        """A continuous {"angular", "linear"} dict or a discrete action id
        as one base-velocity command (STOP sends none)."""
        c = self.cfg
        if isinstance(action, dict):
            self.robot.command_base_velocity(action["angular"], action["linear"])
        elif action == MOVE_FORWARD:
            self.robot.command_base_velocity(0.0, c.forward_step / c.time_step)
        elif action == TURN_LEFT:
            self.robot.command_base_velocity(math.radians(c.turn_deg) / c.time_step, 0.0)
        elif action == TURN_RIGHT:
            self.robot.command_base_velocity(-math.radians(c.turn_deg) / c.time_step, 0.0)

    def step(self, action) -> Dict[str, Any]:
        self._drive(action)
        return self.observe()

    def observe(self) -> Dict[str, Any]:
        xy, yaw = self.robot.xy_yaw
        exy, eyaw = self._to_episodic(xy, yaw)
        cams = self.robot.get_camera_data(["frontleft_depth", "frontright_depth"])
        depths = [self._norm_depth(c.image, self.cfg.max_body_cam_depth) for c in cams.values()]
        depth = np.hstack(depths) if depths else np.zeros((240, 848), np.float32)
        return {"depth": depth, "robot_xy": exy, "heading": eyaw, "goal": self.goal}

    @staticmethod
    def _norm_depth(depth_mm: np.ndarray, max_depth: float, min_depth: float = 0.0) -> np.ndarray:
        d = depth_mm.astype(np.float32) / 1000.0  # mm -> m
        return np.clip((d - min_depth) / (max_depth - min_depth), 0.0, 1.0)


class ObjectNavEnv(PointNavEnv):
    """ObjectNav on the robot: the body depth cameras for the obstacle map
    and the gripper camera's RGB.

    The observation follows objectnav_env.py:118-230: ``obstacle_depths``
    (per camera its depth, camera -> EPISODIC transform, fx/fy and top-down
    fov), ``nav_depth`` (the front pair side by side, for PointNav), the
    hand camera's RGB, transform and intrinsics (it has no depth, which
    makes the policy infer depth), and the pose in the episodic frame.
    """

    def __init__(self, robot: BaseRobot, cfg: Optional[RealityEnvConfig] = None):
        super().__init__(robot, cfg)
        self.target_object = ""
        self.steps = 0

    def reset(self, target_object: str) -> Dict[str, Any]:  # type: ignore[override]
        self.target_object = target_object
        self.steps = 0
        xy, yaw = self.robot.xy_yaw
        self._boot = (xy.copy(), yaw)
        return self.observe()

    def step(self, action) -> Dict[str, Any]:  # type: ignore[override]
        # An arm-yaw action moves the gripper camera, not the base
        # (objectnav_env.py:102-113). Only exactly -1 means a base action
        # (the reference's sentinel, objectnav_env.py:104): an inequality
        # would send the negative initial yaws (-90/-60/-30 deg) to the
        # base, and no INITIAL_ARM_YAWS entry equals -1.0 rad. The step
        # counter moves BEFORE the observation (objectnav_env.py:114-117).
        if isinstance(action, dict) and action.get("arm_yaw", -1.0) != -1.0:
            joints = np.zeros(6, np.float32)
            joints[0] = action["arm_yaw"]
            self.robot.set_arm_joints(joints, travel_time=0.5)
        else:
            self._drive(action)
        self.steps += 1
        return self.observe()

    def _tf_episodic(self, tf_camera_to_global: np.ndarray) -> np.ndarray:
        """camera -> episodic, in xyz conventions (objectnav_env.py:139-142)."""
        bxy, byaw = self._boot
        c, s = math.cos(byaw), math.sin(byaw)
        tf_episodic_to_global = np.array(
            [[c, -s, 0, bxy[0]], [s, c, 0, bxy[1]], [0, 0, 1, 0], [0, 0, 0, 1]],
            np.float32,
        )
        tf_global_to_episodic = np.linalg.inv(tf_episodic_to_global)
        return tf_global_to_episodic @ tf_camera_to_global @ CAM_TO_XYZ

    def observe(self) -> Dict[str, Any]:
        c = self.cfg
        xy, yaw = self.robot.xy_yaw
        exy, eyaw = self._to_episodic(xy, yaw)
        body_ids = (
            BODY_DEPTH_CAMERAS
            if self.steps <= c.all_cams_until_step
            else BODY_DEPTH_CAMERAS[:2]
        )
        cams = self.robot.get_camera_data(body_ids + ["hand_color"])

        obstacle_depths = []
        for cid in body_ids:
            cam = cams[cid]
            depth = self._norm_depth(cam.image, c.max_body_cam_depth)
            # Spot's front cameras are mounted sideways: their top-down fov
            # comes from fy and the height (objectnav_env.py:197-200).
            fov = (
                get_fov(cam.fy, depth.shape[0])
                if cid.startswith("front")
                else get_fov(cam.fx, depth.shape[1])
            )
            obstacle_depths.append(
                {
                    "depth": depth,
                    "tf": self._tf_episodic(cam.tf_camera_to_global),
                    "fx": cam.fx,
                    "fy": cam.fy,
                    "topdown_fov": fov,
                    "max_depth": c.max_body_cam_depth,
                }
            )

        # PointNav's depth: the front pair side by side, holes read as far
        # (objectnav_env.py:180-184).
        fl = self._norm_depth(cams["frontleft_depth"].image, c.max_body_cam_depth)
        fr = self._norm_depth(cams["frontright_depth"].image, c.max_body_cam_depth)
        nav_depth = np.hstack([fr, fl])
        nav_depth[nav_depth == 0] = 1.0

        hand = cams["hand_color"]
        return {
            "robot_xy": exy,
            "heading": eyaw,
            "obstacle_depths": obstacle_depths,
            "nav_depth": nav_depth,
            "rgb": hand.image,
            "hand_tf": self._tf_episodic(hand.tf_camera_to_global),
            "hand_fx": hand.fx,
            "hand_fy": hand.fy,
            "hand_fov": get_fov(hand.fx, hand.image.shape[1]),
            "hand_max_depth": c.max_gripper_cam_depth,
            "target_object": self.target_object,
        }
