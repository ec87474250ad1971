"""Habitat adapter: habitat observations -> the batched policy step's inputs.

Counterpart of ``vlfm_tpu/adapters/habitat.py`` (reference:
vlfm/policy/habitat_policies.py, HabitatMixin and the registered
policies). habitat-lab stays an optional host-side dependency: this module
only needs numpy dicts shaped like habitat's observation space, so
``runner/habitat_eval.py``'s ``FakeHabitatEnv`` and recorded traces run
the same code.

Key behaviours mirrored:
- goal id -> class-name tables for HM3D / MP3D (habitat_policies.py:28-51)
- GPS y-flip (habitat gps makes west negative, :186-187)
- depth hole filtering before mapping (:185)
- action ids STOP/FORWARD/LEFT/RIGHT (:54-58)

The policy step is batch-first: one habitat episode is one lane, B = 1.
The agent's key stream is JAX's: ``PRNGKey(0)`` at ``reset``, then one
``split`` per ``act`` (``ops/threefry.py``, bit-exact to ``jax.random``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from vlfm_tpu_torch.config import VLFMConfig
from vlfm_tpu_torch.device import default_device
from vlfm_tpu_torch.mapping.grid import GridSpec2D
from vlfm_tpu_torch.ops import threefry
from vlfm_tpu_torch.policy import itm
from vlfm_tpu_torch.utils.geometry import xyz_yaw_to_tf_matrix

HM3D_ID_TO_NAME = ["chair", "bed", "potted plant", "toilet", "tv", "couch"]
MP3D_ID_TO_NAME = [
    "chair",
    "table|dining table|coffee table|side table|desk",
    "framed photograph",
    "cabinet",
    "pillow",
    "couch",
    "bed",
    "nightstand",
    "potted plant",
    "sink",
    "toilet",
    "stool",
    "towel",
    "tv",
    "shower",
    "bathtub",
    "counter",
    "fireplace",
    "gym equipment",
    "seating",
    "clothes",
]


def goal_name(object_id: int, dataset: str = "hm3d") -> str:
    table = HM3D_ID_TO_NAME if dataset == "hm3d" else MP3D_ID_TO_NAME
    return table[int(object_id)]


def filter_depth(depth: np.ndarray) -> np.ndarray:
    """Interpolate zero-depth holes from the nearest valid column pixel —
    the role of the external depth_camera_filtering package
    (habitat_policies.py:8,185)."""
    if not (depth == 0).any():
        return depth
    out = depth.copy()
    holes = out == 0
    # simple two-pass column fill (down then up)
    for sl in (slice(None, None, 1), slice(None, None, -1)):
        col = out[sl]
        m = col != 0
        idx = np.where(m, np.arange(col.shape[0])[:, None], 0)
        np.maximum.accumulate(idx, axis=0, out=idx)
        col[:] = col[idx, np.arange(col.shape[1])[None, :]]
    out[holes & (out == 0)] = 1.0
    return out


def _lane(x, device: torch.device) -> torch.Tensor:
    """A host array (or a tensor) as one lane on ``device``: (1, ...)."""
    return torch.as_tensor(x, device=device)[None]


@dataclass
class HabitatObsAdapter:
    cfg: VLFMConfig
    dataset: str = "hm3d"
    device: torch.device | str = default_device()

    def observation(self, obs: Dict[str, Any]) -> itm.Observation:
        """The policy observation of one lane (B = 1) on ``device`` from a
        habitat-style obs dict with keys rgb (H,W,3), depth (H,W[,1]), gps
        (2,), compass (1,)."""
        dev = torch.device(self.device)
        depth = np.asarray(obs["depth"], np.float32)
        depth = filter_depth(depth.reshape(depth.shape[:2]))
        x, y = np.asarray(obs["gps"], np.float32)[:2]
        yaw = float(np.asarray(obs["compass"]).reshape(-1)[0])
        cam = torch.from_numpy(np.array([x, -y, self.cfg.camera.camera_height], np.float32)).to(dev)
        heading = torch.tensor([yaw], dtype=torch.float32, device=dev)
        return itm.Observation(
            depth=_lane(depth, dev),
            tf_camera_to_episodic=xyz_yaw_to_tf_matrix(cam[:, None], heading).permute(2, 0, 1),
            robot_xy=cam[None, :2],
            robot_heading=heading,
        )

    def target_object(self, obs: Dict[str, Any]) -> str:
        return goal_name(int(np.asarray(obs["objectgoal"]).reshape(-1)[0]), self.dataset)

    @property
    def non_coco_caption(self) -> str:
        # MP3D multi-class caption (habitat_policies.py:136)
        if self.dataset == "mp3d":
            return " . ".join(MP3D_ID_TO_NAME).replace("|", " . ") + " ."
        return ""


class HabitatVLFMAgent:
    """Drop-in agent: habitat obs dict in, habitat action id out.

    The analogue of the registered HabitatITMPolicyV2. ``perceive(rgb
    uint8 (H, W, 3), target)`` returns (cosines (C,), masks (K, H, W),
    valid (K,)[, object depth (H, W) or None]) as numpy arrays or tensors,
    e.g. ``runner/full_stack.py``'s ``FullStackPerception``. ``pointnav``
    is ``"greedy"`` or a ``PointNavPolicy``. The state and ``last_info``
    (the step's ``StepInfo``) are one lane, B = 1, on ``device``."""

    def __init__(
        self,
        cfg: VLFMConfig,
        spec: GridSpec2D,
        pointnav,
        perceive,
        dataset: str = "hm3d",
        version: str = "v2",
        device: torch.device | str = default_device(),
    ):
        self.cfg = cfg
        self.spec = spec
        self.pointnav = pointnav
        self.perceive = perceive
        self.version = version
        self.device = torch.device(device)
        self.adapter = HabitatObsAdapter(cfg, dataset, self.device)
        self.reset()

    def reset(self) -> None:
        self.state = itm.create_state(self.spec, self.cfg, device=self.device)
        self._rng = threefry.PRNGKey(0, device=self.device)

    def act(self, obs: Dict[str, Any]) -> int:
        target = self.adapter.target_object(obs)
        out = self.perceive(np.asarray(obs["rgb"]), target)
        # perception may return an inferred object depth as a 4th element
        # (the all-ones-depth monocular trigger, base_objectnav_policy.py:314-318)
        cosines, masks, valid = out[:3]
        obj_depth = out[3] if len(out) > 3 and out[3] is not None else None
        self._rng, sub = threefry.split(self._rng)
        dev = self.device
        action, info, self.state = itm.step(
            self.state,
            self.adapter.observation(obs),
            _lane(cosines, dev).to(torch.float32),
            _lane(masks, dev).to(torch.bool),
            _lane(valid, dev).to(torch.bool),
            sub[None],
            object_depth=None if obj_depth is None else _lane(obj_depth, dev).to(torch.float32),
            pointnav=self.pointnav,
            spec=self.spec,
            cfg=self.cfg,
            version=self.version,
        )
        self.last_info = info
        return int(action[0])
