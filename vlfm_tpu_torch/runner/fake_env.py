"""Synthetic ObjectNav environment: the port's copy of the parts of
``vlfm_tpu/runner/fake_env.py`` that a spin and a walk need.

A 2D floor plan of wall segments with heights plus a cylindrical target,
per-pixel ray-cast depth, a depth-shaded RGB frame with the target painted
red, and the discrete ObjectNav actions. Host-side numpy, as in the JAX
package: its frames are what a camera would hand the policy. The other
floor plans, stairs and the oracle shortest path come with the episode
driver (ROADMAP Queue 1). tests/test_torch_host.py holds the frames to the
JAX package's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

STOP, MOVE_FORWARD, TURN_LEFT, TURN_RIGHT = 0, 1, 2, 3


@dataclass
class FloorPlan:
    """Vertical wall segments (x0, y0, x1, y1) with per-wall heights, a floor
    at z=0 and a flat ceiling."""

    walls: List[Tuple[float, float, float, float]]
    target: Tuple[float, float]
    target_radius: float = 0.3
    start: Tuple[float, float] = (0.0, 0.0)
    start_yaw: float = 0.0
    wall_heights: Optional[List[float]] = None  # default: all ceiling-height
    ceiling_height: float = 3.0
    target_height: float = 1.0

    def height_of(self, i: int) -> float:
        return self.ceiling_height if self.wall_heights is None else self.wall_heights[i]


def two_room_plan(seed: int = 0) -> FloorPlan:
    """An 8x16 m two-room apartment with a connecting door; target in the
    far room."""
    rng = np.random.default_rng(seed)
    door_y = float(rng.uniform(-2.0, 2.0))
    walls = [
        (-4.0, -4.0, -4.0, 4.0),
        (-4.0, 4.0, 12.0, 4.0),
        (12.0, 4.0, 12.0, -4.0),
        (12.0, -4.0, -4.0, -4.0),
        # dividing wall at x=4 with a 1.6 m door centred at door_y
        (4.0, -4.0, 4.0, door_y - 0.8),
        (4.0, door_y + 0.8, 4.0, 4.0),
    ]
    tx = float(rng.uniform(7.0, 11.0))
    ty = float(rng.uniform(-3.0, 3.0))
    return FloorPlan(walls=walls, target=(tx, ty), start=(0.0, 0.0), start_yaw=0.0)


@dataclass
class EnvConfig:
    width: int = 640
    height: int = 480
    hfov_deg: float = 79.0
    min_depth: float = 0.5
    max_depth: float = 5.0
    camera_height: float = 0.88
    forward_step: float = 0.25
    turn_deg: float = 30.0
    max_steps: int = 500
    success_radius: float = 1.0


class FakeObjectNavEnv:
    """gym-like ``reset``/``step``; each returns an observation dict with
    ``rgb`` (H, W, 3) uint8, ``depth`` (H, W) in [0, 1], ``robot_xy``,
    ``heading`` and the episode's bookkeeping."""

    def __init__(self, plan: FloorPlan, cfg: Optional[EnvConfig] = None):
        self.plan = plan
        self.cfg = cfg or EnvConfig()
        c = self.cfg
        half_fov = math.radians(c.hfov_deg) / 2
        self._phi = np.linspace(-half_fov, half_fov, c.width)
        fy = c.width / (2 * math.tan(half_fov))
        v = np.arange(c.height, dtype=np.float32)
        self._slope32 = (v - c.height // 2) / np.float32(fy)  # >0 looks down
        self._cos_phi32 = np.cos(self._phi).astype(np.float32)
        self._heights32 = np.asarray([plan.height_of(i) for i in range(len(plan.walls))], np.float32)
        # pose-independent floor/ceiling depth limit per row
        cam_h = np.float32(c.camera_height)
        s = self._slope32
        with np.errstate(divide="ignore"):
            z_floor = np.where(s > 1e-6, cam_h / np.maximum(s, 1e-6), np.inf)
            z_ceil = np.where(s < -1e-6, (plan.ceiling_height - cam_h) / np.maximum(-s, 1e-6), np.inf)
        self._zfc32 = np.minimum(z_floor, z_ceil).astype(np.float32)  # (H,)
        self.reset()

    def reset(self):
        self.x, self.y = self.plan.start
        self.yaw = self.plan.start_yaw
        self.steps = 0
        self.done = False
        self.called_stop = False
        self.path_length = 0.0
        self.collisions = 0
        return self._observe()

    def step(self, action: int):
        assert not self.done
        c = self.cfg
        if action == STOP:
            self.called_stop = True
            self.done = True
        elif action == MOVE_FORWARD:
            nx = self.x + c.forward_step * math.cos(self.yaw)
            ny = self.y + c.forward_step * math.sin(self.yaw)
            if self._segment_clear(self.x, self.y, nx, ny, clearance=0.18):
                self.path_length += math.hypot(nx - self.x, ny - self.y)
                self.x, self.y = nx, ny
            else:
                self.collisions += 1
        elif action == TURN_LEFT:
            self.yaw += math.radians(c.turn_deg)
        elif action == TURN_RIGHT:
            self.yaw -= math.radians(c.turn_deg)
        self.steps += 1
        if self.steps >= c.max_steps:
            self.done = True
        return self._observe()

    def _ray_walls(self, ox, oy, bearings):
        """Per-wall planar intersection distances: (Nw, W), inf when missed."""
        dx, dy = np.cos(bearings), np.sin(bearings)
        out = np.full((len(self.plan.walls), len(bearings)), np.inf)
        for i, (x0, y0, x1, y1) in enumerate(self.plan.walls):
            ex, ey = x1 - x0, y1 - y0
            den = dx * ey - dy * ex
            with np.errstate(divide="ignore", invalid="ignore"):
                t = ((x0 - ox) * ey - (y0 - oy) * ex) / den
                u = ((x0 - ox) * dy - (y0 - oy) * dx) / den
            ok = (den != 0) & (t > 1e-6) & (u >= 0) & (u <= 1)
            out[i] = np.where(ok, t, np.inf)
        return out

    def _ray_target(self, ox, oy, bearings):
        dx, dy = np.cos(bearings), np.sin(bearings)
        tx, ty = self.plan.target
        fx, fy = tx - ox, ty - oy
        b = fx * dx + fy * dy
        disc = b * b - (fx * fx + fy * fy - self.plan.target_radius**2)
        with np.errstate(invalid="ignore"):
            t = b - np.sqrt(np.maximum(disc, 0.0))
        return np.where((disc > 0) & (t > 1e-6), t, np.inf)

    def _segment_clear(self, x0, y0, x1, y1, clearance=0.0) -> bool:
        """Whether the base can move from (x0, y0) to (x1, y1): it collides
        with walls of any height and with the target."""
        d = math.hypot(x1 - x0, y1 - y0)
        if d == 0:
            return True
        bearing = np.array([math.atan2(y1 - y0, x1 - x0)])
        t = min(self._ray_walls(x0, y0, bearing).min(axis=0)[0], self._ray_target(x0, y0, bearing)[0])
        return bool(t > d + clearance)

    def _observe(self):
        """Per-pixel ray casting against walls (with heights), floor,
        ceiling and the target cylinder."""
        c = self.cfg
        plan = self.plan
        bearings = self.yaw - self._phi
        cam_h = np.float32(c.camera_height)
        t_walls = self._ray_walls(self.x, self.y, bearings)  # (Nw, W) planar
        t_target = self._ray_target(self.x, self.y, bearings)  # (W,)
        cos_phi = self._cos_phi32
        slope = self._slope32  # (H,)

        # A pixel ray hits a wall iff its height there lies in [0, wall
        # height]; each wall is tested only on the band of rows it can cover.
        zf = np.where(np.isfinite(t_walls), t_walls * cos_phi[None, :], np.inf).astype(np.float32)
        h, w = slope.shape[0], zf.shape[1]
        zbest = np.empty((h, w), np.float32)
        zbest[:] = self._zfc32[:, None]
        h_at = np.empty((h, w), np.float32)
        ok = np.empty((h, w), bool)
        slope_col = slope[:, None]

        def _row_band(zmin: float, zmax: float, top: float) -> tuple:
            """Rows whose slope can satisfy 0 <= cam_h - s*z <= top for some
            z in [zmin, zmax]; +-2 rows absorb f32-vs-f64 boundary rounding."""
            s_hi = float(cam_h) / zmin
            s_lo = (float(cam_h) - top) / (zmin if top > cam_h else zmax)
            r0 = max(int(np.searchsorted(slope, s_lo, "left")) - 2, 0)
            r1 = min(int(np.searchsorted(slope, s_hi, "right")) + 2, h)
            return r0, r1

        with np.errstate(invalid="ignore"):
            for i in range(zf.shape[0]):
                zi = zf[i]
                fin = np.isfinite(zi)
                if not fin.any():
                    continue
                r0, r1 = _row_band(float(zi[fin].min()), float(zi[fin].max()), float(self._heights32[i]))
                if r0 >= r1:
                    continue
                ha, oks, zb = h_at[r0:r1], ok[r0:r1], zbest[r0:r1]
                np.multiply(slope_col[r0:r1], zi[None, :], out=ha)
                np.subtract(cam_h, ha, out=ha)
                np.less_equal(ha, self._heights32[i], out=oks)
                oks &= ha >= 0.0
                oks &= zi[None, :] < zb
                np.copyto(zb, np.broadcast_to(zi[None, :], zb.shape), where=oks)
        zt = np.where(np.isfinite(t_target), t_target * cos_phi, 1e9).astype(np.float32)
        mask = np.zeros((h, w), bool)
        ztmin = float(zt.min())
        if ztmin < 1e8:
            th = float(plan.target_height)
            r0, r1 = _row_band(ztmin, float(zt[zt < 1e8].max()), th)
            if r0 < r1:
                with np.errstate(invalid="ignore"):
                    h_t = cam_h - slope_col[r0:r1] * zt[None, :]
                    t_ok = (zt < 1e8)[None, :] & (h_t >= 0.0) & (h_t <= th)
                    zt_band = np.where(t_ok, zt[None, :], np.inf)
                    zb = zbest[r0:r1]
                    mask[r0:r1] = t_ok & (zt_band <= zb) & (zt_band < c.max_depth)
                    np.minimum(zb, zt_band, out=zb)

        depth = np.clip((zbest - c.min_depth) / (c.max_depth - c.min_depth), 0.0, 1.0)
        target_visible = bool(mask.sum() > 2)
        shade = ((1.0 - depth) * 200 + 30).astype(np.uint8)
        rgb = np.empty((h, w, 3), np.uint8)
        np.copyto(rgb, shade[..., None])
        rgb[mask] = (220, 40, 40)
        dist = max(
            0.0,
            math.hypot(plan.target[0] - self.x, plan.target[1] - self.y) - plan.target_radius,
        )
        # synthetic ITM cosine: high when the target is in view
        cosine = 0.9 if target_visible else max(0.2, 0.45 - 0.025 * dist)
        return {
            "depth": depth,
            "rgb": rgb,
            "target_mask": mask,
            "target_visible": target_visible,
            "cosine": float(cosine),
            "robot_xy": np.array([self.x, self.y], np.float32),
            "heading": float(self.yaw),
            "distance_to_goal": float(dist),
            "done": self.done,
            "steps": self.steps,
        }
