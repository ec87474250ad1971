"""Robot interfaces for real-world deployment (host code, numpy only).

Counterpart of ``vlfm_tpu/reality/robots.py`` (reference:
vlfm/reality/robots/base_robot.py, bdsw_robot.py, camera_ids.py): the
``BaseRobot`` interface, ``FakeRobot``, a random-data test double whose
frames and poses equal the JAX package's bit for bit (the same
``np.random.default_rng(seed)`` draws in the same order), and
``BDSWRobot``, the Boston Dynamics Spot wrapper, which needs the BD SDK's
``spot_wrapper`` object.
"""

from __future__ import annotations

import abc
import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

# Spot camera id -> (height, width) (camera_ids.py:30-59).
SPOT_CAMERA_SHAPES: Dict[str, Tuple[int, int]] = {
    "frontleft_depth": (240, 424),
    "frontright_depth": (240, 424),
    "left_depth": (240, 424),
    "right_depth": (240, 424),
    "back_depth": (240, 424),
    "hand_depth": (224, 171),
    "hand_color": (480, 640),
}


# Camera convention (+z forward, +x right, +y down) -> xyz convention (+x
# forward, +y left, +z up); objectnav_env.py:139-142. Cameras report
# camera-convention transforms; the env remaps them.
CAM_TO_XYZ = np.array(
    [[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]], np.float32
)


@dataclass
class CameraData:
    image: np.ndarray
    fx: float
    fy: float
    tf_camera_to_global: np.ndarray  # (4, 4), camera conventions


class BaseRobot(abc.ABC):
    @property
    @abc.abstractmethod
    def xy_yaw(self) -> Tuple[np.ndarray, float]:
        """Global (x, y) and yaw."""

    @property
    def arm_joints(self) -> np.ndarray:
        return np.zeros(6, np.float32)

    @abc.abstractmethod
    def get_camera_data(self, camera_ids: List[str]) -> Dict[str, CameraData]:
        ...

    @abc.abstractmethod
    def command_base_velocity(self, angular: float, linear: float) -> None:
        ...

    def set_arm_joints(self, joints: np.ndarray, travel_time: float = 1.0) -> None:
        pass

    def open_gripper(self) -> None:
        pass


class FakeRobot(BaseRobot):
    """Random-data test double (base_robot.py:83-122 role): Spot's image
    shapes and intrinsics, depth uniform in 0.5-5 m, and the pose
    integrated from velocity commands."""

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._x = self._y = self._yaw = 0.0

    @property
    def xy_yaw(self):
        return np.array([self._x, self._y], np.float32), self._yaw

    def get_camera_data(self, camera_ids):
        out = {}
        for cid in camera_ids:
            h, w = SPOT_CAMERA_SHAPES.get(cid, (480, 640))
            if "depth" in cid:
                img = self._rng.uniform(500, 5000, (h, w)).astype(np.uint16)  # mm
            else:
                img = self._rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
            fx = w / (2 * math.tan(math.radians(60.0) / 2))
            base = np.eye(4, dtype=np.float32)
            base[0, 3], base[1, 3], base[2, 3] = self._x, self._y, 0.5
            c, s = math.cos(self._yaw), math.sin(self._yaw)
            base[0, 0], base[0, 1], base[1, 0], base[1, 1] = c, -s, s, c
            # The camera faces the robot's forward: base @ inv(CAM_TO_XYZ).
            tf = (base @ CAM_TO_XYZ.T).astype(np.float32)
            out[cid] = CameraData(image=img, fx=fx, fy=fx, tf_camera_to_global=tf)
        return out

    def command_base_velocity(self, angular, linear, duration: float = 0.5):
        self._yaw += angular * duration
        self._x += linear * duration * math.cos(self._yaw)
        self._y += linear * duration * math.sin(self._yaw)


class BDSWRobot(BaseRobot):
    """Boston Dynamics Spot through ``spot_wrapper`` (bdsw_robot.py role);
    ``spot`` is the BD SDK's wrapper object."""

    def __init__(self, spot):
        self.spot = spot

    @property
    def xy_yaw(self):
        x, y, yaw = self.spot.get_xy_yaw()
        return np.array([x, y], np.float32), float(yaw)

    def get_camera_data(self, camera_ids):
        out = {}
        responses = self.spot.get_image_responses(camera_ids)
        for cid, resp in zip(camera_ids, responses):
            out[cid] = CameraData(
                image=self.spot.image_response_to_cv2(resp),
                fx=resp.source.pinhole.intrinsics.focal_length.x,
                fy=resp.source.pinhole.intrinsics.focal_length.y,
                tf_camera_to_global=self.spot.get_transform(resp),
            )
        return out

    def command_base_velocity(self, angular, linear):
        self.spot.set_base_velocity(x_vel=linear, y_vel=0.0, ang_vel=angular, vel_time=0.5)

    def set_arm_joints(self, joints, travel_time: float = 1.0):
        self.spot.set_arm_joint_positions(joints, travel_time=travel_time)

    def open_gripper(self):
        self.spot.open_gripper()
