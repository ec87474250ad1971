"""The monocular metric depth contract (the ZoeDepth role).

Counterpart of ``vlfm_tpu/models/monodepth.py`` (reference:
vlfm/policy/reality_policies.py:40-42,156-169): the robot's gripper camera
has RGB only, and an all-ones depth image makes the policy infer depth for
the object map, normalised to the mapping range
(base_objectnav_policy.py:314-318). The model is
``models/zoedepth.ZoeDepth``; ``MonocularDepth.init_random`` gives a tiny
one for tests.
"""

from __future__ import annotations

from typing import Protocol

import torch

from vlfm_tpu_torch.device import default_device


class MonocularDepthModel(Protocol):
    """(B, H, W, 3) uint8 -> (B, H, W) depth normalised to [0, 1] over
    (min_depth, max_depth) (reality_policies.py:156-169)."""

    def infer_depth(self, rgb_uint8: torch.Tensor, min_depth: float, max_depth: float) -> torch.Tensor: ...


class MonocularDepth:
    """Tests' factory: a tiny ZoeDepth that keeps the contract."""

    @classmethod
    def init_random(cls, seed: int = 0, device: torch.device | str = default_device()) -> MonocularDepthModel:
        from vlfm_tpu_torch.models.zoedepth import ZoeDepth

        return ZoeDepth.init_random(seed=seed, device=device)
