"""Synthetic ObjectNav environment: the port's copy of
``vlfm_tpu/runner/fake_env.py``.

A 2D floor plan of wall segments with heights plus a cylindrical target
(two-room, furnished, open-room and stairs plans), per-pixel ray-cast
depth, a depth-shaded RGB frame with the target painted red, the discrete
ObjectNav actions, ground-truth perception (an ITM-like cosine and the
target's mask), the agent's height on a stair ramp, and the BFS geodesic
shortest path and oracle action. Host-side numpy, as in the JAX package:
its frames are what a camera would hand the policy.
tests/test_torch_host.py holds its frames, plans, shortest paths and
oracle actions to the JAX package's.

Episode workload parameters follow the reference envelope (BASELINE.md):
640x480 RGBD, HFOV 79 deg, depth 0.5-5.0 m, forward 0.25 m, turn 30 deg,
max 500 steps.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

STOP, MOVE_FORWARD, TURN_LEFT, TURN_RIGHT = 0, 1, 2, 3


@dataclass
class FloorPlan:
    """World made of vertical wall segments (x0, y0, x1, y1) with per-wall
    heights, a floor plane at z=0 and a flat ceiling — so depth images have
    real vertical structure (floor below the obstacle height band, table-height
    obstacles inside/below it, views over low furniture)."""

    walls: List[Tuple[float, float, float, float]]
    target: Tuple[float, float]
    target_radius: float = 0.3
    start: Tuple[float, float] = (0.0, 0.0)
    start_yaw: float = 0.0
    wall_heights: Optional[List[float]] = None  # default: all ceiling-height
    ceiling_height: float = 3.0
    target_height: float = 1.0
    # stairs region (x0, x1, rise): agent z ramps linearly across it
    stairs: Optional[Tuple[float, float, float]] = None

    def height_of(self, i: int) -> float:
        if self.wall_heights is None:
            return self.ceiling_height
        return self.wall_heights[i]


def two_room_plan(seed: int = 0) -> FloorPlan:
    """An 8x16 m two-room apartment with a connecting door; target in the
    far room so the agent must explore through the door."""
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


def furnished_room_plan(seed: int = 0) -> FloorPlan:
    """A room with half-height furniture: a 0.5 m table (below the obstacle
    band — visible in depth, NOT an obstacle) and a 0.75 m counter (inside the
    band — an obstacle the agent can see over)."""
    rng = np.random.default_rng(seed)
    walls = [
        (-5.0, -5.0, -5.0, 5.0),
        (-5.0, 5.0, 5.0, 5.0),
        (5.0, 5.0, 5.0, -5.0),
        (5.0, -5.0, -5.0, -5.0),
        (1.5, -1.0, 1.5, 1.0),   # table edge, 0.5 m tall
        (-1.0, 2.0, 1.0, 2.0),   # counter, 0.75 m tall
    ]
    heights = [3.0, 3.0, 3.0, 3.0, 0.5, 0.75]
    ang = rng.uniform(0, 2 * np.pi)
    r = rng.uniform(2.5, 4.0)
    return FloorPlan(
        walls=walls,
        wall_heights=heights,
        target=(float(r * np.cos(ang)), float(r * np.sin(ang))),
    )


def stairs_plan(seed: int = 0) -> FloorPlan:
    """Open room with a stair ramp along x in [1, 3] rising 1.2 m — episodes
    crossing it trip the TraveledStairs measure."""
    plan = open_room_plan(seed)
    return FloorPlan(
        walls=plan.walls, target=plan.target, stairs=(1.0, 3.0, 1.2)
    )


def hidden_stairs_plan(seed: int = 0) -> FloorPlan:
    """Two rooms with the stair ramp BEFORE the connecting door and the target
    hidden in the far room: short-budget episodes cross the stairs without
    ever seeing the target — the never_saw_target_traveled_stairs taxonomy
    branch (episode_stats_logger.py:64-71)."""
    plan = two_room_plan(seed)
    return FloorPlan(
        walls=plan.walls, target=plan.target, start=plan.start,
        start_yaw=plan.start_yaw, stairs=(0.25, 1.75, 1.5),
    )


def open_room_plan(seed: int = 0) -> FloorPlan:
    rng = np.random.default_rng(seed)
    walls = [
        (-5.0, -5.0, -5.0, 5.0),
        (-5.0, 5.0, 5.0, 5.0),
        (5.0, 5.0, 5.0, -5.0),
        (5.0, -5.0, -5.0, -5.0),
    ]
    ang = rng.uniform(0, 2 * np.pi)
    r = rng.uniform(2.5, 4.0)
    return FloorPlan(
        walls=walls, target=(float(r * np.cos(ang)), float(r * np.sin(ang)))
    )


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
    success_radius: float = 1.0  # ObjectNav-style "near the object" success


class FakeObjectNavEnv:
    """gym-like reset/step matching the reality adapters' shape
    (reality/pointnav_env.py:17, reality/objectnav_env.py:42)."""

    def __init__(self, plan: FloorPlan, cfg: Optional[EnvConfig] = None):
        self.plan = plan
        self.cfg = cfg or EnvConfig()
        self.path_feasible = True  # set by shortest_path_length()
        self._phi = np.linspace(
            -math.radians(self.cfg.hfov_deg) / 2,
            math.radians(self.cfg.hfov_deg) / 2,
            self.cfg.width,
        )
        # static per-env render tables (the pixel stage runs in f32: at
        # meter-scale depths the f32 rel-error ~1e-7 is far below the
        # 1/255-normalized quantization every consumer applies)
        fy = self.cfg.width / (2 * math.tan(math.radians(self.cfg.hfov_deg) / 2))
        v = np.arange(self.cfg.height, dtype=np.float32)
        self._slope32 = (v - self.cfg.height // 2) / np.float32(fy)  # >0 looks down
        self._cos_phi32 = np.cos(self._phi).astype(np.float32)
        self._heights32 = np.asarray(
            [plan.height_of(i) for i in range(len(plan.walls))], np.float32
        )
        # pose-independent floor/ceiling depth limit per row
        cam_h = np.float32(self.cfg.camera_height)
        s = self._slope32
        with np.errstate(divide="ignore"):
            z_floor = np.where(s > 1e-6, cam_h / np.maximum(s, 1e-6), np.inf)
            z_ceil = np.where(
                s < -1e-6,
                (plan.ceiling_height - cam_h) / np.maximum(-s, 1e-6),
                np.inf,
            )
        self._zfc32 = np.minimum(z_floor, z_ceil).astype(np.float32)  # (H,)
        self.reset()

    # --- simulation ---------------------------------------------------------
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
        r = self.plan.target_radius
        fx, fy = tx - ox, ty - oy
        b = fx * dx + fy * dy
        c2 = fx * fx + fy * fy - r * r
        disc = b * b - c2
        with np.errstate(invalid="ignore"):
            t = b - np.sqrt(np.maximum(disc, 0.0))
        ok = (disc > 0) & (t > 1e-6)
        return np.where(ok, t, np.inf)

    def _ray(self, ox, oy, bearings):
        """First-hit planar distance against full-height geometry + target —
        used for collision checks (the base collides with furniture of any
        height)."""
        t_walls = self._ray_walls(ox, oy, bearings).min(axis=0)
        t_target = self._ray_target(ox, oy, bearings)
        return np.minimum(t_walls, t_target), t_target < t_walls

    @property
    def agent_z(self) -> float:
        """Agent height above the boot floor (stairs ramp)."""
        if self.plan.stairs is None:
            return 0.0
        x0, x1, rise = self.plan.stairs
        return float(rise * np.clip((self.x - x0) / max(x1 - x0, 1e-6), 0.0, 1.0))

    def _segment_clear(self, x0, y0, x1, y1, clearance=0.0) -> bool:
        d = math.hypot(x1 - x0, y1 - y0)
        if d == 0:
            return True
        bearing = np.array([math.atan2(y1 - y0, x1 - x0)])
        t, _ = self._ray(x0, y0, bearing)
        return bool(t[0] > d + clearance)

    # --- observation --------------------------------------------------------
    def _observe(self):
        """Per-PIXEL ray casting against walls (with heights), floor, ceiling
        and the target cylinder — the depth image has true vertical structure
        (the obstacle height band, hole filling and see-over-furniture paths
        are exercised closed-loop)."""
        c = self.cfg
        plan = self.plan
        bearings = self.yaw - self._phi
        cam_h = np.float32(c.camera_height)

        t_walls = self._ray_walls(self.x, self.y, bearings)  # (Nw, W) planar
        t_target = self._ray_target(self.x, self.y, bearings)  # (W,)
        cos_phi = self._cos_phi32
        slope = self._slope32  # (H,)

        # walls: candidate z-depth = planar t * cos(phi); a pixel ray hits
        # the wall iff its height there lies within [0, wall_height]. Looped
        # per wall over contiguous (H, W) buffers with in-place updates —
        # the one-shot (Nw, H, W) broadcast costs 13 ms/frame in strided
        # numpy traffic and the farm pays it per lane per step on a host
        # core that is also running the episode loop.
        zf = np.where(
            np.isfinite(t_walls), t_walls * cos_phi[None, :], np.inf
        ).astype(np.float32)  # (Nw, W); inf rays stay inf (nan-safe compares)
        h, w = slope.shape[0], zf.shape[1]
        # floor/ceiling limit as the initial hit (identical final min to the
        # former init-at-inf + late np.minimum, and it prunes wall writes
        # beyond the floor/ceiling early)
        zbest = np.empty((h, w), np.float32)
        zbest[:] = self._zfc32[:, None]
        h_at = np.empty((h, w), np.float32)
        ok = np.empty((h, w), bool)
        slope_col = slope[:, None]

        def _row_band(zmin: float, zmax: float, top: float) -> tuple:
            """Rows whose slope can satisfy 0 <= cam_h - s*z <= top for some
            z in [zmin, zmax]: s in [(cam_h-top)/z*, cam_h/zmin]. slope is
            ascending; +-2 rows absorb f32-vs-f64 boundary rounding so the
            in-band (exact, original) comparisons see every candidate row."""
            s_hi = float(cam_h) / zmin
            s_lo = (float(cam_h) - top) / (zmin if top > cam_h else zmax)
            r0 = max(int(np.searchsorted(slope, s_lo, "left")) - 2, 0)
            r1 = min(int(np.searchsorted(slope, s_hi, "right")) + 2, h)
            return r0, r1

        with np.errstate(invalid="ignore"):
            for i in range(zf.shape[0]):
                zi = zf[i]
                fin = np.isfinite(zi)
                if not fin.any():  # wall fully missed / behind
                    continue
                zfin = zi[fin]
                # the wall only occupies a band of image rows — run the
                # exact per-pixel test on that slab only (the full-frame
                # per-wall passes were the farm workers' hottest loop)
                r0, r1 = _row_band(
                    float(zfin.min()), float(zfin.max()),
                    float(self._heights32[i]),
                )
                if r0 >= r1:
                    continue
                ha, oks, zb = h_at[r0:r1], ok[r0:r1], zbest[r0:r1]
                np.multiply(slope_col[r0:r1], zi[None, :], out=ha)
                np.subtract(cam_h, ha, out=ha)
                np.less_equal(ha, self._heights32[i], out=oks)
                oks &= ha >= 0.0
                oks &= zi[None, :] < zb
                np.copyto(zb, np.broadcast_to(zi[None, :], zb.shape), where=oks)
        # target cylinder (target_height m tall), same row-band treatment
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

        # clip((z - min)/range, 0, 1) == the former clip-then-normalize with
        # the inf->1.0 where() folded in (inf/range clips to 1.0)
        depth = np.clip(
            (zbest - c.min_depth) / (c.max_depth - c.min_depth), 0.0, 1.0
        )

        target_visible = bool(mask.sum() > 2)
        # synthetic RGB: shaded from depth, the target painted red — enough
        # signal for the real perception stack to run end-to-end
        shade = ((1.0 - depth) * 200 + 30).astype(np.uint8)
        rgb = np.empty((h, w, 3), np.uint8)
        np.copyto(rgb, shade[..., None])
        rgb[mask] = (220, 40, 40)

        # distance to the object's surface, not its centre (habitat ObjectNav
        # success is viewpoint-based, i.e. effectively surface-based)
        dist = max(
            0.0,
            math.hypot(self.plan.target[0] - self.x, self.plan.target[1] - self.y)
            - self.plan.target_radius,
        )
        # synthetic ITM cosine: high when the target is in view, mild rise as
        # the agent gets closer, floor at 0.2
        cosine = 0.9 if target_visible else max(0.2, 0.45 - 0.025 * dist)

        return {
            "depth": depth,
            "rgb": rgb,
            "target_mask": mask,
            "target_visible": target_visible,
            "cosine": float(cosine),
            "robot_xy": np.array([self.x, self.y], np.float32),
            "heading": float(self.yaw),
            "agent_z": self.agent_z,  # stairs ramp height (TraveledStairs)
            "distance_to_goal": float(dist),
            "done": self.done,
            "steps": self.steps,
        }

    # --- oracle shortest path (for SPL) ------------------------------------
    def _raster_grid(self, resolution: float = 0.1):
        """Rasterize the floor plan: (blocked, x0, y0, nx, ny). Cached."""
        key = ("grid", resolution)
        if getattr(self, "_grid_cache", None) and key in self._grid_cache:
            return self._grid_cache[key]
        xs = [w[i] for w in self.plan.walls for i in (0, 2)] + [
            self.plan.start[0],
            self.plan.target[0],
        ]
        ys = [w[i] for w in self.plan.walls for i in (1, 3)] + [
            self.plan.start[1],
            self.plan.target[1],
        ]
        pad = 0.5
        x0, x1 = min(xs) - pad, max(xs) + pad
        y0, y1 = min(ys) - pad, max(ys) + pad
        nx = int((x1 - x0) / resolution) + 1
        ny = int((y1 - y0) / resolution) + 1
        blocked = np.zeros((nx, ny), bool)
        for (ax, ay, bx, by) in self.plan.walls:
            n = int(math.hypot(bx - ax, by - ay) / (resolution / 2)) + 1
            for i in range(n + 1):
                px = ax + (bx - ax) * i / n
                py = ay + (by - ay) * i / n
                ix, iy = int((px - x0) / resolution), int((py - y0) / resolution)
                blocked[max(0, ix - 1) : ix + 2, max(0, iy - 1) : iy + 2] = True
        if not hasattr(self, "_grid_cache"):
            self._grid_cache = {}
        self._grid_cache[key] = (blocked, x0, y0, nx, ny)
        return self._grid_cache[key]

    def _dist_field_from(self, source_xy, resolution: float = 0.1) -> np.ndarray:
        """Full BFS geodesic distance field from ``source_xy`` (meters)."""
        import collections

        blocked, x0, y0, nx, ny = self._raster_grid(resolution)
        s = (int((source_xy[0] - x0) / resolution), int((source_xy[1] - y0) / resolution))
        dist = np.full((nx, ny), np.inf)
        dist[s] = 0.0
        q = collections.deque([s])
        diag = resolution * math.sqrt(2)
        while q:
            cx, cy = q.popleft()
            for ddx in (-1, 0, 1):
                for ddy in (-1, 0, 1):
                    if ddx == 0 and ddy == 0:
                        continue
                    mx, my = cx + ddx, cy + ddy
                    if 0 <= mx < nx and 0 <= my < ny and not blocked[mx, my]:
                        nd = dist[cx, cy] + (diag if ddx and ddy else resolution)
                        if nd < dist[mx, my]:
                            dist[mx, my] = nd
                            q.append((mx, my))
        return dist

    def shortest_path_length(self, resolution: float = 0.1) -> float:
        """BFS geodesic distance start->target on a rasterized floor plan."""
        _, x0, y0, _, _ = self._raster_grid(resolution)
        field = self._target_field(resolution)
        s = (int((self.plan.start[0] - x0) / resolution),
             int((self.plan.start[1] - y0) / resolution))
        d = field[s]
        self.path_feasible = bool(np.isfinite(d))
        return float(d) if np.isfinite(d) else float(math.hypot(
            self.plan.target[0] - self.plan.start[0],
            self.plan.target[1] - self.plan.start[1],
        ))

    def _target_field(self, resolution: float = 0.1) -> np.ndarray:
        key = ("target_field", resolution)
        if getattr(self, "_grid_cache", None) and key in self._grid_cache:
            return self._grid_cache[key]
        field = self._dist_field_from(self.plan.target, resolution)
        self._grid_cache[key] = field
        return field

    def oracle_action(self, resolution: float = 0.1) -> int:
        """Shortest-path-follower action toward the target — the role of the
        frontier_exploration BaseExplorer sensor consumed by the reference's
        Oracle/SuperOracle FBE baselines (habitat_policies.py:240-261):
        descend the BFS geodesic field, turn toward the best neighbor, STOP
        inside the success radius."""
        tx, ty = self.plan.target
        if math.hypot(self.x - tx, self.y - ty) <= self.cfg.success_radius:
            return STOP
        blocked, x0, y0, nx, ny = self._raster_grid(resolution)
        field = self._target_field(resolution)
        ix = int((self.x - x0) / resolution)
        iy = int((self.y - y0) / resolution)
        best, best_d = None, np.inf
        # look one body-length ahead so the bearing is stable between cells
        r = max(int(round(self.cfg.forward_step / resolution)), 1)
        for ddx in (-r, 0, r):
            for ddy in (-r, 0, r):
                if ddx == 0 and ddy == 0:
                    continue
                mx, my = ix + ddx, iy + ddy
                if 0 <= mx < nx and 0 <= my < ny and np.isfinite(field[mx, my]):
                    if field[mx, my] < best_d:
                        best_d, best = field[mx, my], (ddx, ddy)
        if best is None:
            return STOP  # isolated cell: nothing reachable
        bearing = math.atan2(best[1], best[0])
        dyaw = (bearing - self.yaw + math.pi) % (2 * math.pi) - math.pi
        half_turn = math.radians(self.cfg.turn_deg) / 2
        if dyaw > half_turn:
            return TURN_LEFT
        if dyaw < -half_turn:
            return TURN_RIGHT
        return MOVE_FORWARD
