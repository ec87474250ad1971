"""Policy configuration: the port's copy of ``vlfm_tpu/config.py``.

The same frozen dataclasses with the same field names and defaults, so a
configuration moves between the two packages unchanged
(tests/test_torch_host.py holds the two to each other), and the same
``load_config`` (dict, JSON or YAML). Host-only: no tensors here.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class CameraConfig:
    """Static camera intrinsics (habitat_policies.py:89-91 derivation)."""

    height: int = 480
    width: int = 640
    hfov_deg: float = 79.0
    min_depth: float = 0.5
    max_depth: float = 5.0
    camera_height: float = 0.88

    @property
    def hfov(self) -> float:
        return math.radians(self.hfov_deg)

    @property
    def fx(self) -> float:
        return self.width / (2 * math.tan(self.hfov / 2))

    @property
    def fy(self) -> float:
        return self.fx

    @property
    def object_map_cone_fov(self) -> float:
        return 2 * math.atan((self.width / 2) / self.fx)


@dataclass(frozen=True)
class VLFMConfig:
    """Field-for-field mirror of the reference policy config
    (base_objectnav_policy.py:374-398) plus the camera and grid settings.
    Fields the port does not read yet are kept so that configurations stay
    interchangeable."""

    name: str = "ITMPolicyV2"
    text_prompt: str = "Seems like there is a target_object ahead."
    pointnav_policy_path: str = "data/pointnav_weights.pth"
    depth_image_shape: Tuple[int, int] = (224, 224)
    pointnav_stop_radius: float = 0.9
    use_max_confidence: bool = False
    object_map_erosion_size: int = 5
    use_object_map_dbscan: bool = True
    exploration_thresh: float = 0.0
    obstacle_map_area_threshold: float = 1.5  # square meters
    min_obstacle_height: float = 0.61
    max_obstacle_height: float = 0.88
    hole_area_thresh: int = 100000
    use_vqa: bool = False
    vqa_prompt: str = "Is this "
    coco_threshold: float = 0.8
    non_coco_threshold: float = 0.4
    agent_radius: float = 0.18
    # "default" | "replace" | "equal_weighting" (value_map.py:74-75)
    map_fusion_type: str = "default"

    camera: CameraConfig = field(default_factory=CameraConfig)
    map_size: int = 1024
    pixels_per_meter: int = 20
    map_pad: int = 160
    max_frontiers: int = 32
    max_frontier_cells: int = 512
    max_detections_per_frame: int = 8
    sam_frame_capacity: Optional[int] = None
    vqa_slot_capacity: Optional[int] = None
    object_map_slots: int = 64
    object_map_points_per_slot: int = 512
    num_init_turns: int = 12  # a full 360-degree spin
    sync_explored_areas: bool = False

    @property
    def value_channels(self) -> int:
        return len(self.text_prompt.split("|"))


def load_config(path_or_dict) -> VLFMConfig:
    """Build a VLFMConfig from a dict, JSON, or YAML file (the JAX
    package's ``load_config``: unknown keys raise, ``camera`` is a nested
    dict, $MAP_FUSION_TYPE overrides the fusion type)."""
    if isinstance(path_or_dict, dict):
        d = dict(path_or_dict)
    else:
        text = open(path_or_dict).read()
        if str(path_or_dict).endswith((".yaml", ".yml")):
            import yaml

            d = yaml.safe_load(text) or {}
        else:
            d = json.loads(text) if text.strip() else {}
    cam = d.pop("camera", None)
    names = {f.name for f in dataclasses.fields(VLFMConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"Unknown config keys: {sorted(unknown)}")
    cfg = VLFMConfig(**d)
    if cam is not None:
        cfg = dataclasses.replace(cfg, camera=CameraConfig(**cam))
    if os.environ.get("MAP_FUSION_TYPE"):
        cfg = dataclasses.replace(cfg, map_fusion_type=os.environ["MAP_FUSION_TYPE"])
    return cfg
