"""Value map: semantic value + confidence over the episodic grid.

Counterpart of ``vlfm_tpu/mapping/value_map.py`` with the same fusion math
(reference: vlfm/mapping/value_map.py):

- confidence-cone projection of the current view (``ops/cone.py``),
- "silence" pixels whose new confidence is below the decision threshold AND
  below the stored confidence,
- then max-confidence replacement or confidence-weighted averaging, plus
  the 'replace' and 'equal_weighting' ablations.

The update is window-local. Unlike the JAX version it writes the state
tensors IN PLACE and returns the same ``ValueMapState``. The state is
batch-first (B lanes, one episode each; B = 1 for one episode), each lane
with its own pose, cosines and explored area, and an update reads nothing
back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from benchmark.frozen.device import default_device
from benchmark.frozen.mapping.grid import GridSpec2D
from benchmark.frozen.ops.cone import depth_row_max, visible_confidence_window
from benchmark.frozen.ops.median import masked_median
from benchmark.frozen.ops.windows import read_window, window_index, write_window
from benchmark.frozen.utils.geometry import extract_yaw

DECISION_THRESHOLD = 0.35  # reference: value_map.py:41

FUSION_DEFAULT = 0
FUSION_REPLACE = 1
FUSION_EQUAL_WEIGHTING = 2


class ValueMapState(NamedTuple):
    conf: torch.Tensor  # (B, S, S) float32 confidence
    values: torch.Tensor  # (B, S, S, C) float32


def create(spec: GridSpec2D, value_channels: int, *, batch: int = 1,
           device: torch.device | str = default_device()) -> ValueMapState:
    s = spec.storage_size
    return ValueMapState(
        conf=torch.zeros((batch, s, s), dtype=torch.float32, device=device),
        values=torch.zeros((batch, s, s, value_channels), dtype=torch.float32, device=device),
    )


def reset(state: ValueMapState, lanes: torch.Tensor | None = None) -> ValueMapState:
    """Clear every lane in place, or the lanes where the (B,) bool ``lanes``
    is set."""
    if lanes is None:
        state.conf.zero_()
        state.values.zero_()
    else:
        state.conf.masked_fill_(lanes[:, None, None], 0.0)
        state.values.masked_fill_(lanes[:, None, None, None], 0.0)
    return state


def update(
    state: ValueMapState,
    spec: GridSpec2D,
    values: torch.Tensor,  # (B, C)
    depth: torch.Tensor,  # (B, H, W) normalized [0, 1]
    tf_camera_to_episodic: torch.Tensor,  # (B, 4, 4)
    min_depth: float,
    max_depth: float,
    fov: float,
    *,
    window: int = 256,
    use_max_confidence: bool = True,
    fusion_type: int = FUSION_DEFAULT,
    explored: Optional[torch.Tensor] = None,  # (B, S, S) bool
) -> ValueMapState:
    """One observation per lane, in place. Mirrors ValueMap.update_map."""
    dev = state.conf.device
    cam_xy = tf_camera_to_episodic[:, :2, 3]
    yaw = extract_yaw(tf_camera_to_episodic)
    rc = spec.to_storage(spec.xy_to_px(cam_xy))

    row_m = depth_row_max(depth, min_depth, max_depth)
    new_conf = visible_confidence_window(
        row_m,
        yaw,
        torch.full((), fov, dtype=torch.float32, device=dev),
        torch.full((), max_depth, dtype=torch.float32, device=dev),
        window=window,
        pixels_per_meter=spec.pixels_per_meter,
    )

    at = window_index(rc, window, state.conf.shape[1])
    conf_w = read_window(state.conf, at)
    vals_w = read_window(state.values, at)

    if explored is not None:
        # Zero everything outside the explored area (value_map.py:369-375).
        state.conf.masked_fill_(~explored, 0.0)
        state.values.masked_fill_(~explored[..., None], 0.0)
        expl_w = read_window(explored, at)
        new_conf = torch.where(expl_w, new_conf, 0.0)
        conf_w = torch.where(expl_w, conf_w, 0.0)
        vals_w = torch.where(expl_w[..., None], vals_w, 0.0)

    values = values.to(torch.float32)[:, None, None, :]
    if fusion_type == FUSION_REPLACE:
        # Ablation: the current observation overwrites (value_map.py:377-385).
        seen = new_conf > 0
        conf_w = torch.where(seen, new_conf, conf_w)
        vals_w = torch.where(seen[..., None], values, vals_w)
        write_window(state.conf, conf_w, at)
        write_window(state.values, vals_w, at)
        return state

    if fusion_type == FUSION_EQUAL_WEIGHTING:
        # Ablation: force both confidences to 1 where nonzero (:386-391).
        conf_w = torch.where(conf_w > 0, 1.0, conf_w)
        new_conf = torch.where(new_conf > 0, 1.0, new_conf)

    # Silence low-confidence new pixels (:396-399).
    silence = (new_conf < DECISION_THRESHOLD) & (new_conf < conf_w)
    new_conf = torch.where(silence, 0.0, new_conf)

    if use_max_confidence:
        higher = new_conf > conf_w
        vals_w = torch.where(higher[..., None], values, vals_w)
        conf_w = torch.where(higher, new_conf, conf_w)
    else:
        denom = conf_w + new_conf
        safe = torch.where(denom == 0, 1.0, denom)
        w1 = torch.where(denom == 0, 0.0, conf_w / safe)
        w2 = torch.where(denom == 0, 0.0, new_conf / safe)
        vals_w = vals_w * w1[..., None] + values * w2[..., None]
        conf_w = conf_w * w1 + new_conf * w2

    write_window(state.conf, conf_w, at)
    write_window(state.values, vals_w, at)
    return state


def waypoint_values(
    state: ValueMapState,
    spec: GridSpec2D,
    waypoints: torch.Tensor,  # (B, K, 2) world meters (padded)
    valid: torch.Tensor,  # (B, K) bool
    *,
    radius_px: int,
) -> torch.Tensor:
    """Per-waypoint per-channel median of nonzero values within a radius.

    Mirrors ValueMap.sort_waypoints' value extraction
    (img_utils.pixel_value_within_radius, reduction='median'). Returns
    (B, K, C); invalid waypoints get -1. All lanes' K windows are gathered in
    one indexing op.
    """
    dev = state.values.device
    s = state.values.shape[1]
    win = 2 * radius_px + 1
    dr = torch.arange(win, device=dev) - radius_px
    circle = (dr[:, None] ** 2 + dr[None, :] ** 2) <= radius_px**2  # (win, win)

    rc = spec.to_storage(spec.xy_to_px(waypoints)).to(torch.int64)  # (B, K, 2)
    start = rc - radius_px  # dynamic_slice's rules, as in ops/windows.py
    start = torch.clamp(torch.where(start < 0, start + s, start), 0, s - win)
    ar = torch.arange(win, device=dev)
    rows = (start[..., 0:1] + ar)[..., :, None]  # (B, K, win, 1)
    cols = (start[..., 1:2] + ar)[..., None, :]  # (B, K, 1, win)
    lanes = torch.arange(waypoints.shape[0], device=dev)[:, None, None, None]
    block = state.values[lanes, rows, cols]  # (B, K, win, win, C)

    b, k, c = block.shape[0], block.shape[1], block.shape[-1]
    m = circle[..., None] & (block > 0)
    flat_v = block.permute(0, 1, 4, 2, 3).reshape(b, k, c, win * win)
    flat_m = m.permute(0, 1, 4, 2, 3).reshape(b, k, c, win * win)
    per_c = masked_median(flat_v, flat_m)  # (B, K, C)
    return torch.where(valid[..., None], per_c, -1.0)


def sort_waypoints_single_channel(values: torch.Tensor, waypoints: torch.Tensor, valid: torch.Tensor):
    """Descending stable sort along the last waypoint axis; invalid
    waypoints sink to the end with -inf. values, valid (..., K); waypoints
    (..., K, 2)."""
    v = torch.where(valid, values, -torch.inf)
    order = torch.argsort(-v, dim=-1, stable=True)
    pts = torch.gather(waypoints, -2, order[..., None].expand(*order.shape, waypoints.shape[-1]))
    return pts, torch.gather(v, -1, order), order
