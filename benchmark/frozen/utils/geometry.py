"""Geometry primitives as plain functions on torch tensors.

Counterpart of ``vlfm_tpu/utils/geometry.py``; every function keeps the JAX
version's signature, shapes and f32 arithmetic so the two agree bit for bit
on the CPU. Functions that the reference implements as variable-length
subsets (``within_fov_cone``) return boolean masks here as well.
"""

from __future__ import annotations

import math

import torch


def wrap_heading(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to [-pi, pi).

    The floored modulo is spelled as ``fmod`` plus a sign fix, the same
    formulation ``jnp.remainder`` lowers to, so the result is exact."""
    period = 2 * math.pi
    r = torch.fmod(theta + math.pi, period)
    r = torch.where(r < 0, r + period, r)
    return r - math.pi


def rotation_matrix_2d(angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack([torch.stack([c, -s]), torch.stack([s, c])])


def rho_theta(curr_pos: torch.Tensor, curr_heading: torch.Tensor, curr_goal: torch.Tensor):
    """Polar coordinates of ``curr_goal`` in the agent's local frame.

    rho = distance to goal; theta = CCW radians the agent must turn to face it.
    Positions are (..., 2) and headings (...), one per lane.
    """
    local = curr_goal - curr_pos
    c, s = torch.cos(-curr_heading), torch.sin(-curr_heading)
    lx = c * local[..., 0] - s * local[..., 1]
    ly = s * local[..., 0] + c * local[..., 1]
    rho = torch.sqrt(lx * lx + ly * ly)
    theta = torch.atan2(ly, lx)
    return rho, theta


def pt_from_rho_theta(rho: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    return torch.stack([rho * torch.cos(theta), rho * torch.sin(theta)])


def xyz_yaw_to_tf_matrix(xyz: torch.Tensor, yaw: torch.Tensor) -> torch.Tensor:
    """4x4 homogeneous transform: rotation about z by ``yaw``, translation ``xyz``."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([c, -s, zero, xyz[0]]),
            torch.stack([s, c, zero, xyz[1]]),
            torch.stack([zero, zero, one, xyz[2]]),
            torch.stack([zero, zero, zero, one]),
        ]
    )


def extract_yaw(tf: torch.Tensor) -> torch.Tensor:
    """Yaw of (..., 4, 4) transforms (rotation of x-axis about z)."""
    return torch.atan2(tf[..., 1, 0], tf[..., 0, 0])


def transform_points(tf: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) rigid transforms to (..., N, 3) points -> (..., N, 3).

    Metric coordinates need full f32: on a GPU keep
    ``torch.backends.cuda.matmul.allow_tf32`` off (PyTorch's default)."""
    return torch.matmul(points, tf[..., :3, :3].transpose(-1, -2)) + tf[..., None, :3, 3]


def within_fov_cone(
    cone_origin: torch.Tensor,
    cone_angle: torch.Tensor,
    cone_fov: float,
    cone_range: float,
    points: torch.Tensor,
) -> torch.Tensor:
    """Boolean mask of (..., N, >=3) ``points`` inside a horizontal FOV cone
    with (..., 3) origin and (...) angle, one cone per lane."""
    d = points[..., :3] - cone_origin[..., None, :]
    dists = torch.linalg.vector_norm(d, dim=-1)
    angles = torch.atan2(d[..., 1], d[..., 0])
    diffs = wrap_heading(angles - cone_angle[..., None])
    return (dists <= cone_range) & (torch.abs(diffs) <= cone_fov / 2)


def closest_point_within_threshold(
    points: torch.Tensor, target: torch.Tensor, threshold: float, valid: torch.Tensor | None = None
) -> torch.Tensor:
    """Index of the point closest to ``target`` if within ``threshold`` else -1.

    ``valid`` optionally masks out padded rows (distance -> +inf).
    """
    d = torch.linalg.vector_norm(points[:, :2] - target[:2], dim=1)
    if valid is not None:
        d = torch.where(valid, d, torch.inf)
    idx = torch.argmin(d)
    return torch.where(d[idx] <= threshold, idx, -1)


def get_point_cloud(
    depth_m: torch.Tensor, mask: torch.Tensor, fx: float, fy: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Back-project a metric depth image into a camera-frame point cloud.

    Camera convention: +x forward, +y left, +z up, i.e.
    point = (z_depth, -x_img, -y_img) with x_img = (u - W//2) z / fx and
    y_img = (v - H//2) z / fy. Returns ``(points (H*W, 3), valid (H*W,))``.
    """
    h, w = depth_m.shape
    v = torch.arange(h, dtype=depth_m.dtype, device=depth_m.device)[:, None]
    u = torch.arange(w, dtype=depth_m.dtype, device=depth_m.device)[None, :]
    z = depth_m
    x = (u - w // 2) * z / fx
    y = (v - h // 2) * z / fy
    pts = torch.stack([z, -x, -y + torch.zeros_like(z)], dim=-1).reshape(-1, 3)
    return pts, mask.reshape(-1)


def get_fov(focal_length: float, image_height_or_width: int) -> float:
    """Field of view (radians) from a focal length and image extent. Host-side."""
    return 2 * math.atan((image_height_or_width / 2) / focal_length)


def calculate_vfov(hfov: float, width: int, height: int) -> float:
    """Vertical FOV from horizontal FOV and sensor aspect. Host-side."""
    dfov = 2 * math.atan(math.tan(hfov / 2))
    return 2 * math.atan(math.tan(dfov / 2) * (height / math.sqrt(width**2 + height**2)))


def focal_length_from_fov(fov_rad: float, image_width: int) -> float:
    """fx = W / (2 tan(fov/2))."""
    return image_width / (2 * math.tan(fov_rad / 2))


def convert_to_global_frame(
    agent_pos: torch.Tensor, agent_yaw, local_pos: torch.Tensor
) -> torch.Tensor:
    """Agent-local 3D position -> global frame."""
    agent_pos = torch.as_tensor(agent_pos, dtype=torch.float32)
    yaw = torch.as_tensor(agent_yaw, dtype=torch.float32, device=agent_pos.device)
    tf = xyz_yaw_to_tf_matrix(agent_pos, yaw)
    local = torch.as_tensor(local_pos, dtype=torch.float32, device=agent_pos.device)
    hom = torch.cat([local, torch.ones(1, device=agent_pos.device)])
    out = tf @ hom
    return out[:3] / out[3]
