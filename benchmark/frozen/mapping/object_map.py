"""Object point-cloud map with detection-slot bookkeeping, batch-first.

Counterpart of ``vlfm_tpu/mapping/object_map.py`` (reference:
vlfm/mapping/object_point_cloud_map.py) with the same semantics per lane:
a ring of D detection slots of M points each, per-point range flags (a
detection's points beyond 95 % of max depth, or all points of a detection
too far off-centre, are "suspect"), mask erosion, a stratified subsample of
the eroded mask drawn with jax's threefry bits (``ops/threefry.py``), the
DBSCAN largest-cluster filter (``ops/clustering.py``), the 1 m too-close
rejection, suspect eviction when the camera looks at a slot's suspect
points again, and closest-point target selection with move hysteresis.

Every state field has a leading lane axis: B episodes in one call, as
JAX's vmapped step runs them; one episode is B = 1. The functions return
new states and read nothing back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.frozen.device import default_device
from benchmark.frozen.ops import threefry
from benchmark.frozen.ops.clustering import largest_cluster_mask
from benchmark.frozen.ops.morphology import erode_repeated_3x3
from benchmark.frozen.ops.sparse import first_true, stratified_valid_sample
from benchmark.frozen.utils.geometry import extract_yaw, transform_points, within_fov_cone

DEFAULT_SLOTS = 64
DEFAULT_POINTS_PER_SLOT = 512


class ObjectMapState(NamedTuple):
    points: torch.Tensor  # (B, D, M, 3) episodic frame
    point_valid: torch.Tensor  # (B, D, M) bool
    slot_used: torch.Tensor  # (B, D) bool
    point_in_range: torch.Tensor  # (B, D, M) bool; False marks suspect points
    cursor: torch.Tensor  # (B,) int32 ring-buffer write position
    last_target: torch.Tensor  # (B, 2)
    has_last_target: torch.Tensor  # (B,) bool


def create(slots: int = DEFAULT_SLOTS, points_per_slot: int = DEFAULT_POINTS_PER_SLOT, *, batch: int = 1,
           device: torch.device | str = default_device()) -> ObjectMapState:
    b, d, m = batch, slots, points_per_slot
    return ObjectMapState(
        points=torch.zeros((b, d, m, 3), dtype=torch.float32, device=device),
        point_valid=torch.zeros((b, d, m), dtype=torch.bool, device=device),
        slot_used=torch.zeros((b, d), dtype=torch.bool, device=device),
        point_in_range=torch.zeros((b, d, m), dtype=torch.bool, device=device),
        cursor=torch.zeros(b, dtype=torch.int32, device=device),
        last_target=torch.zeros((b, 2), dtype=torch.float32, device=device),
        has_last_target=torch.zeros(b, dtype=torch.bool, device=device),
    )


def reset(state: ObjectMapState, lanes: torch.Tensor | None = None) -> ObjectMapState:
    """A cleared state: every lane, or the lanes where the (B,) bool
    ``lanes`` is set."""
    if lanes is None:
        b, d, m = state.point_valid.shape
        return create(d, m, batch=b, device=state.points.device)
    return ObjectMapState(*(
        torch.where(lanes.reshape(-1, *([1] * (f.ndim - 1))), torch.zeros_like(f), f) for f in state
    ))


def has_object(state: ObjectMapState) -> torch.Tensor:
    """(B,) bool: a used slot holds a valid point."""
    return (state.slot_used[..., None] & state.point_valid).flatten(1).any(dim=1)


def _too_offset(mask: torch.Tensor) -> torch.Tensor:
    """(...,) bool for (..., H, W) masks: bounding box entirely in the
    left/right third AND touching the 5 % edge band
    (object_point_cloud_map.py:269-297)."""
    w = mask.shape[-1]
    cols = mask.any(dim=-2)
    any_at_all = cols.any(dim=-1)
    first = first_true(cols, -1)
    last = w - 1 - first_true(cols.flip(-1), -1)
    third = w // 3
    left = (last + 1 <= third) & (first <= int(0.05 * w))
    right = (first >= 2 * third) & (last + 1 >= int(0.95 * w))
    return any_at_all & (left | right)


def _subsample(key: torch.Tensor, eroded: torch.Tensor, budget: int):
    """Up to ``budget`` pixel indices drawn uniformly from each (..., H, W)
    eroded mask with its (..., 2) key: a stratified sample of the 2x2-block
    coarsening (a block is set when any of its 4 pixels is, so no detection
    is lost however small), then one set pixel of each sampled block under
    a per-sample random rotation of the 4 slots.

    Returns (..., budget) flat full-resolution indices and keep-mask."""
    h, w = eroded.shape[-2:]
    lead = eroded.shape[:-2]
    blocks = eroded.reshape(*lead, h // 2, 2, w // 2, 2).transpose(-3, -2)
    blocks = blocks.reshape(*lead, (h // 2) * (w // 2), 4)  # bit k = pixel (k//2, k%2)
    coarse = blocks.any(dim=-1)
    ws = w // 2
    keys = threefry.split(key, 2)
    idx_s, keep = stratified_valid_sample(coarse, budget, keys[..., 0, :])
    bits = torch.gather(blocks, -2, idx_s[..., None].expand(*idx_s.shape, 4))  # (..., budget, 4)
    # first set bit under a per-sample random rotation of the 4 slots
    rot = threefry.randint(keys[..., 1, :], (budget,), 0, 4).to(torch.int64)
    order = (rot[..., None] + torch.arange(4, device=eroded.device)) % 4
    avail = torch.gather(bits, -1, order)
    slot = torch.gather(order, -1, avail.to(torch.int32).argmax(dim=-1, keepdim=True))[..., 0]
    row = 2 * (idx_s // ws) + slot // 2
    col = 2 * (idx_s % ws) + slot % 2
    return row * w + col, keep


def _rank_select(dists: torch.Tensor, use: torch.Tensor) -> torch.Tensor:
    """Index of the reference's no-dbscan representative point along the
    last axis: the median of the nearest 25 % of points, rank floor(n/4)//2
    in distance order (rank 0 when n < 4); invalid points sort last."""
    order = torch.argsort(torch.where(use, dists, torch.inf), dim=-1, stable=True)
    n = use.sum(dim=-1, keepdim=True)
    rank = torch.where(n // 4 > 0, (n // 4) // 2, 0)
    return torch.gather(order, -1, rank)[..., 0]


def _detections(keys, depth, masks, tf_camera_to_episodic, min_depth, max_depth, fx, fy, *,
                erosion_size, use_dbscan, dbscan_eps, dbscan_min_points_per_5000, points_per_slot):
    """Each lane's K detections, (B, K) at once: clouds (B, K, M, 3) in the
    episodic frame, keep and in-range masks (B, K, M), and ok (B, K)."""
    b, k, h, w = masks.shape
    m = points_per_slot
    dev = depth.device
    f32 = torch.float32
    min_d = torch.full((), min_depth, dtype=f32, device=dev)
    max_d = torch.full((), max_depth, dtype=f32, device=dev)
    depth_far = torch.where(depth == 0, 1.0, depth)
    scaled = (depth_far * (max_d - min_d) + min_d).reshape(b, 1, h * w)

    eroded = erode_repeated_3x3(masks, erosion_size)
    idx, keep = _subsample(keys, eroded, m)  # (B, K, M)
    v = (idx // w).to(f32)
    u = (idx % w).to(f32)
    z = torch.gather(scaled.expand(b, k, h * w), 2, idx)
    x = (u - w // 2) * z / torch.full((), fx, dtype=f32, device=dev)
    y = (v - h // 2) * z / torch.full((), fy, dtype=f32, device=dev)
    cloud_cam = torch.stack([z, -x, -y], dim=-1)  # camera frame, see get_point_cloud

    if use_dbscan:
        min_pts = max(round(dbscan_min_points_per_5000 * m / 5000.0), 2)
        keep = largest_cluster_mask(cloud_cam.reshape(b * k, m, 3), keep.reshape(b * k, m), dbscan_eps,
                                    min_pts).reshape(b, k, m)

    # per-point range markers (object_point_cloud_map.py:48-61): an offset
    # detection is all-suspect; otherwise each point past 95 % range is
    # suspect while the rest of the SAME detection stays in range
    offset = _too_offset(masks)
    in_range = keep & ~offset[..., None] & (cloud_cam[..., 0] <= max_d * 0.95)

    tf = tf_camera_to_episodic[:, None]  # (B, 1, 4, 4)
    cloud_epi = transform_points(tf, cloud_cam)
    cam_pos = tf[..., None, :3, 3]
    dists = torch.linalg.vector_norm(cloud_epi - cam_pos, dim=-1)
    # too-close detections are untrusted (:64-70); without dbscan the
    # reference measures the quartile-median point instead of the minimum
    if use_dbscan:
        closest = torch.where(keep, dists, torch.inf).amin(dim=-1)
    else:
        closest = torch.gather(dists, -1, _rank_select(dists, keep)[..., None])[..., 0]
    ok = keep.any(dim=-1) & (closest >= 1.0)
    return cloud_epi, keep, in_range, ok


def _write_slots(state: ObjectMapState, slots: torch.Tensor, clouds, keeps, in_ranges, oks) -> ObjectMapState:
    """Write detection k of each lane into ring slot ``slots[b, k]``; slot D
    drops it (``mode="drop"``). Slots of one lane's written detections are
    distinct (K <= D)."""
    b, d = state.slot_used.shape
    k = slots.shape[1]
    # For each slot, the detection written there (K: none); column D takes
    # the dropped ones and is cut off.
    src = torch.full((b, d + 1), k, dtype=torch.int64, device=slots.device)
    src.scatter_(1, slots, torch.arange(k, device=slots.device).expand(b, k).contiguous())
    src = src[:, :d]
    write = src < k
    take = src.clamp(max=k - 1)

    def put(old, new):
        idx = take.reshape(b, d, *([1] * (new.ndim - 2))).expand(b, d, *new.shape[2:])
        sel = write.reshape(b, d, *([1] * (new.ndim - 2)))
        return torch.where(sel, torch.gather(new, 1, idx), old)

    return state._replace(
        points=put(state.points, clouds),
        point_valid=put(state.point_valid, keeps),
        slot_used=state.slot_used | write,
        point_in_range=put(state.point_in_range, in_ranges),
        cursor=state.cursor + oks.sum(dim=1, dtype=torch.int32),
    )


def update_batch(
    state: ObjectMapState,
    keys: torch.Tensor,  # (B, 2) threefry keys
    depth: torch.Tensor,  # (B, H, W) normalized
    object_masks: torch.Tensor,  # (B, K, H, W) bool from the segmenter
    masks_valid: torch.Tensor,  # (B, K) bool
    tf_camera_to_episodic: torch.Tensor,  # (B, 4, 4)
    min_depth: float,
    max_depth: float,
    fx: float,
    fy: float,
    *,
    erosion_size: int = 5,
    use_dbscan: bool = True,
    dbscan_eps: float = 0.2,
    dbscan_min_points_per_5000: float = 100.0,
) -> ObjectMapState:
    """Insert each lane's K detections at once, in consecutive ring slots
    from the lane's cursor (the semantics and slot order of K sequential
    ``update`` calls). Each lane's key is split into K detection keys, as
    ``jax.random.split(rng, K)``; invalid or rejected detections are
    dropped."""
    d, m = state.point_valid.shape[1:]
    k = object_masks.shape[1]
    det_keys = threefry.split(keys, k)  # (B, K, 2)
    clouds, keeps, in_ranges, oks = _detections(
        det_keys, depth, object_masks, tf_camera_to_episodic, min_depth, max_depth, fx, fy,
        erosion_size=erosion_size, use_dbscan=use_dbscan, dbscan_eps=dbscan_eps,
        dbscan_min_points_per_5000=dbscan_min_points_per_5000, points_per_slot=m)
    oks = oks & masks_valid
    ranks = torch.cumsum(oks, dim=1) - oks.to(torch.int64)  # exclusive prefix count
    slots = torch.where(oks, (state.cursor[:, None] + ranks) % d, d)
    return _write_slots(state, slots, clouds, keeps, in_ranges, oks)


def update(
    state: ObjectMapState,
    keys: torch.Tensor,  # (B, 2)
    depth: torch.Tensor,  # (B, H, W) normalized
    object_mask: torch.Tensor,  # (B, H, W) bool
    tf_camera_to_episodic: torch.Tensor,  # (B, 4, 4)
    min_depth: float,
    max_depth: float,
    fx: float,
    fy: float,
    *,
    erosion_size: int = 5,
    use_dbscan: bool = True,
    dbscan_eps: float = 0.2,
    dbscan_min_points_per_5000: float = 100.0,
) -> ObjectMapState:
    """Insert one detection per lane with that lane's key as it is (no-op
    for a lane whose detection fails the filters). The reference for
    ``update_batch``: K calls with ``split(key, K)``'s keys fill the same
    slots."""
    d, m = state.point_valid.shape[1:]
    clouds, keeps, in_ranges, oks = _detections(
        keys[:, None], depth, object_mask[:, None], tf_camera_to_episodic, min_depth, max_depth, fx, fy,
        erosion_size=erosion_size, use_dbscan=use_dbscan, dbscan_eps=dbscan_eps,
        dbscan_min_points_per_5000=dbscan_min_points_per_5000, points_per_slot=m)
    slots = torch.where(oks, (state.cursor[:, None] % d).to(torch.int64), d)
    return _write_slots(state, slots, clouds, keeps, in_ranges, oks)


def update_explored(
    state: ObjectMapState,
    tf_camera_to_episodic: torch.Tensor,  # (B, 4, 4)
    max_depth: float,
    cone_fov: float,
) -> ObjectMapState:
    """Drop each slot's SUSPECT-point group when any of its suspect points
    re-enters the half-range FOV cone of the lane's camera; the in-range
    points of the same detection survive (object_point_cloud_map.py:102-132).
    A slot whose points are all removed no longer counts for has_object."""
    dev = state.points.device
    cam = tf_camera_to_episodic[:, :3, 3]
    yaw = extract_yaw(tf_camera_to_episodic)
    half_range = torch.full((), max_depth, dtype=torch.float32, device=dev) * 0.5
    fov = torch.full((), cone_fov, dtype=torch.float32, device=dev)
    cone = within_fov_cone(cam[:, None], yaw[:, None], fov, half_range, state.points)  # (B, D, M)
    suspect = state.point_valid & ~state.point_in_range
    hits = (cone & suspect).any(dim=-1) & state.slot_used
    new_valid = state.point_valid & ~(hits[..., None] & ~state.point_in_range)
    return state._replace(point_valid=new_valid, slot_used=state.slot_used & new_valid.any(dim=-1))


def _target_points(state: ObjectMapState):
    """(points (B, D*M, 3), valid, in-range) of the used slots."""
    b, d, m = state.point_valid.shape
    pts = state.points.reshape(b, d * m, 3)
    pvalid = (state.point_valid & state.slot_used[..., None]).reshape(b, d * m)
    in_range = state.point_in_range.reshape(b, d * m) & pvalid
    return pts, pvalid, in_range


def get_best_object(state: ObjectMapState, curr_position: torch.Tensor, use_dbscan: bool = True):
    """((B, 2) target, new state): each lane's target point with move
    hysteresis (:77-100). With dbscan the representative is the closest
    point in 2D (:165-169); without, the reference's quartile-median point
    under a 3D distance to (x, y, 0.5) (:170-189)."""
    pts, pvalid, in_range = _target_points(state)
    # Prefer in-range points when any exist (:134-141).
    use = torch.where(in_range.any(dim=-1, keepdim=True), in_range, pvalid)
    pos = curr_position[:, :2]
    if use_dbscan:
        dist = torch.linalg.vector_norm(pts[..., :2] - pos[:, None], dim=-1)
        pick = torch.argmin(torch.where(use, dist, torch.inf), dim=-1)
    else:
        ref = torch.cat([pos, torch.full_like(pos[:, :1], 0.5)], dim=-1)
        dist = torch.linalg.vector_norm(pts - ref[:, None], dim=-1)
        pick = _rank_select(dist, use)
    closest = torch.gather(pts[..., :2], 1, pick[:, None, None].expand(-1, 1, 2))[:, 0]

    delta = torch.linalg.vector_norm(closest - state.last_target, dim=-1)
    far_away = torch.linalg.vector_norm(pos - closest, dim=-1) > 2.0
    keep_old = state.has_last_target & ((delta < 0.1) | ((delta < 0.5) & far_away))
    target = torch.where(keep_old[:, None], state.last_target, closest)
    return target, state._replace(last_target=target, has_last_target=torch.ones_like(state.has_last_target))


def get_target_cloud(state: ObjectMapState):
    """((B, D*M, 3) points, (B, D*M) mask) of each lane's current target
    cloud (in-range points preferred)."""
    pts, pvalid, in_range = _target_points(state)
    return pts, torch.where(in_range.any(dim=-1, keepdim=True), in_range, pvalid)
