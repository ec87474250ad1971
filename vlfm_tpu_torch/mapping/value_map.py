"""Value map: semantic value + confidence over the episodic grid.

Counterpart of ``vlfm_tpu/mapping/value_map.py`` with the same fusion math
(reference: vlfm/mapping/value_map.py):

- confidence-cone projection of the current view (``ops/cone.py``),
- "silence" pixels whose new confidence is below the decision threshold AND
  below the stored confidence,
- then max-confidence replacement or confidence-weighted averaging, plus
  the 'replace' and 'equal_weighting' ablations.

The update is window-local. Unlike the JAX version it writes the state
tensors IN PLACE and returns the same ``ValueMapState``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from vlfm_tpu_torch.mapping.grid import GridSpec2D
from vlfm_tpu_torch.ops.cone import depth_row_max, visible_confidence_window
from vlfm_tpu_torch.ops.median import masked_median
from vlfm_tpu_torch.ops.windows import read_window, write_window
from vlfm_tpu_torch.utils.geometry import extract_yaw

DECISION_THRESHOLD = 0.35  # reference: value_map.py:41

FUSION_DEFAULT = 0
FUSION_REPLACE = 1
FUSION_EQUAL_WEIGHTING = 2


class ValueMapState(NamedTuple):
    conf: torch.Tensor  # (S, S) float32 confidence
    values: torch.Tensor  # (S, S, C) float32


def create(spec: GridSpec2D, value_channels: int, *, device: torch.device | str = "cpu") -> ValueMapState:
    return ValueMapState(
        conf=spec.zeros(device=device), values=spec.zeros(channels=value_channels, device=device)
    )


def reset(state: ValueMapState) -> ValueMapState:
    state.conf.zero_()
    state.values.zero_()
    return state


def update(
    state: ValueMapState,
    spec: GridSpec2D,
    values: torch.Tensor,  # (C,)
    depth: torch.Tensor,  # (H, W) normalized [0, 1]
    tf_camera_to_episodic: torch.Tensor,  # (4, 4)
    min_depth: float,
    max_depth: float,
    fov: float,
    *,
    window: int = 256,
    use_max_confidence: bool = True,
    fusion_type: int = FUSION_DEFAULT,
    explored: Optional[torch.Tensor] = None,  # (S, S) bool
) -> ValueMapState:
    """One observation update, in place. Mirrors ValueMap.update_map."""
    dev = state.conf.device
    cam_xy = tf_camera_to_episodic[:2, 3]
    yaw = extract_yaw(tf_camera_to_episodic)
    rc = spec.to_storage(spec.xy_to_px(cam_xy))

    row_m = depth_row_max(depth, min_depth, max_depth)
    new_conf = visible_confidence_window(
        row_m,
        yaw,
        torch.tensor(fov, dtype=torch.float32, device=dev),
        torch.tensor(max_depth, dtype=torch.float32, device=dev),
        window=window,
        pixels_per_meter=spec.pixels_per_meter,
    )

    conf_w = read_window(state.conf, rc, window).clone()
    vals_w = read_window(state.values, rc, window).clone()

    if explored is not None:
        # Zero everything outside the explored area (value_map.py:369-375).
        state.conf.masked_fill_(~explored, 0.0)
        state.values.masked_fill_(~explored[..., None], 0.0)
        expl_w = read_window(explored, rc, window)
        new_conf = torch.where(expl_w, new_conf, 0.0)
        conf_w = torch.where(expl_w, conf_w, 0.0)
        vals_w = torch.where(expl_w[..., None], vals_w, 0.0)

    values = values.to(torch.float32)
    if fusion_type == FUSION_REPLACE:
        # Ablation: the current observation overwrites (value_map.py:377-385).
        seen = new_conf > 0
        conf_w = torch.where(seen, new_conf, conf_w)
        vals_w = torch.where(seen[..., None], values[None, None, :], vals_w)
        write_window(state.conf, conf_w, rc)
        write_window(state.values, vals_w, rc)
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
        vals_w = torch.where(higher[..., None], values[None, None, :], vals_w)
        conf_w = torch.where(higher, new_conf, conf_w)
    else:
        denom = conf_w + new_conf
        safe = torch.where(denom == 0, 1.0, denom)
        w1 = torch.where(denom == 0, 0.0, conf_w / safe)
        w2 = torch.where(denom == 0, 0.0, new_conf / safe)
        vals_w = vals_w * w1[..., None] + values[None, None, :] * w2[..., None]
        conf_w = conf_w * w1 + new_conf * w2

    write_window(state.conf, conf_w, rc)
    write_window(state.values, vals_w, rc)
    return state


def waypoint_values(
    state: ValueMapState,
    spec: GridSpec2D,
    waypoints: torch.Tensor,  # (K, 2) world meters (padded)
    valid: torch.Tensor,  # (K,) bool
    *,
    radius_px: int,
) -> torch.Tensor:
    """Per-waypoint per-channel median of nonzero values within a radius.

    Mirrors ValueMap.sort_waypoints' value extraction
    (img_utils.pixel_value_within_radius, reduction='median'). Returns (K, C);
    invalid waypoints get -1. All K windows are gathered in one indexing op.
    """
    dev = state.values.device
    s = state.values.shape[0]
    win = 2 * radius_px + 1
    dr = torch.arange(win, device=dev) - radius_px
    circle = (dr[:, None] ** 2 + dr[None, :] ** 2) <= radius_px**2  # (win, win)

    rc = spec.to_storage(spec.xy_to_px(waypoints)).to(torch.int64)  # (K, 2)
    start = rc - radius_px  # dynamic_slice's rules, as in ops/windows.py
    start = torch.clamp(torch.where(start < 0, start + s, start), 0, s - win)
    ar = torch.arange(win, device=dev)
    rows = (start[:, 0:1] + ar)[:, :, None]  # (K, win, 1)
    cols = (start[:, 1:2] + ar)[:, None, :]  # (K, 1, win)
    block = state.values[rows, cols]  # (K, win, win, C)

    k, c = block.shape[0], block.shape[-1]
    m = circle[None, :, :, None] & (block > 0)
    flat_v = block.permute(0, 3, 1, 2).reshape(k, c, win * win)
    flat_m = m.permute(0, 3, 1, 2).reshape(k, c, win * win)
    per_c = masked_median(flat_v, flat_m)  # (K, C)
    return torch.where(valid[:, None], per_c, -1.0)


def sort_waypoints_single_channel(values: torch.Tensor, waypoints: torch.Tensor, valid: torch.Tensor):
    """Descending stable sort; invalid waypoints sink to the end with -inf."""
    v = torch.where(valid, values, -torch.inf)
    order = torch.argsort(-v, stable=True)
    return waypoints[order], v[order], order
