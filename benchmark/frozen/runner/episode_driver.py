"""The step's inputs and outputs as the packed dispatch makes them.

Counterpart of ``vlfm_tpu/runner/episode_driver.py``'s helpers that the
full stack's fused dispatch shares (the episode drivers themselves are not
copied): ``observation`` (device pose and depth to an ``Observation``),
``step_keys`` and ``pack_outputs`` (the (B, 4) output).
"""

from __future__ import annotations

import torch

from benchmark.frozen.config import VLFMConfig
from benchmark.frozen.ops import threefry
from benchmark.frozen.policy import itm
from benchmark.frozen.utils.geometry import xyz_yaw_to_tf_matrix


def observation(depth: torch.Tensor, xy: torch.Tensor, heading: torch.Tensor, cfg: VLFMConfig) -> itm.Observation:
    """(B, H, W) depth, (B, 2) position and (B,) heading on the device ->
    the step's ``Observation``, the camera at ``cfg.camera.camera_height``."""
    xyz = torch.stack([xy[:, 0], xy[:, 1], torch.full_like(heading, cfg.camera.camera_height)])
    return itm.Observation(
        depth=depth,
        tf_camera_to_episodic=xyz_yaw_to_tf_matrix(xyz, heading).permute(2, 0, 1),
        robot_xy=xy,
        robot_heading=heading,
    )


def step_keys(seeds: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """(B, 2) keys ``fold_in(PRNGKey(seed), step)`` from (B,) integer
    tensors, computed on their device: each episode's stream, whatever lane
    or batch it runs in."""
    return threefry.fold_in(threefry.PRNGKey(seeds), steps)


def pack_outputs(action: torch.Tensor, info: itm.StepInfo) -> torch.Tensor:
    """(B, 4) f32 on the device: each lane's action, target_detected and
    goal (small integers are exact in f32)."""
    return torch.cat([action[:, None].to(torch.float32), info.target_detected[:, None].to(torch.float32),
                      info.goal], dim=1)
