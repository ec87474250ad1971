"""Episode metrics and failure-cause taxonomy: the port's copy of
``vlfm_tpu/runner/metrics.py`` (host-side Python and numpy).

Parity targets: habitat's SPL/success/soft-SPL measures as consumed by the
reference harness (vlfm_trainer.py:252-268) and the failure decision tree of
episode_stats_logger.py:44-72.
"""

from __future__ import annotations

from dataclasses import dataclass, asdict
from typing import Optional


@dataclass
class EpisodeResult:
    success: bool
    spl: float
    soft_spl: float
    distance_to_goal: float
    steps: int
    path_length: float
    called_stop: bool
    target_detected: bool
    target_seen: bool
    collisions: int = 0
    failure_cause: Optional[str] = None

    def to_dict(self):
        return asdict(self)


def compute_result(
    *,
    called_stop: bool,
    distance_to_goal: float,
    success_radius: float,
    shortest_path: float,
    path_length: float,
    steps: int,
    max_steps: int,
    target_detected: bool,
    target_seen: bool,
    collisions: int = 0,
    false_positive: Optional[bool] = None,
    traveled_stairs: bool = False,
    feasible: bool = True,
    success_override: Optional[bool] = None,
) -> EpisodeResult:
    # an env that reports success authoritatively (habitat's Success measure)
    # passes it through; otherwise success is derived from the stop/radius
    # rule the reference's task config encodes
    success = (
        bool(success_override)
        if success_override is not None
        else (called_stop and distance_to_goal <= success_radius)
    )
    denom = max(path_length, shortest_path, 1e-6)
    spl = float(success) * shortest_path / denom
    # soft-SPL: progress toward goal scaled by path efficiency
    start_dist = max(shortest_path, 1e-6)
    progress = max(0.0, 1.0 - distance_to_goal / start_dist)
    soft_spl = progress * shortest_path / denom

    cause = None
    if not success:
        cause = determine_failure_cause(
            target_detected=target_detected,
            false_positive=(
                false_positive
                if false_positive is not None
                # fallback when no nav-goal/bbox test is available: a stop far
                # from the goal counts as a false positive
                else (called_stop and distance_to_goal > success_radius)
            ),
            stop_called=called_stop,
            target_seen=target_seen,
            traveled_stairs=traveled_stairs,
            feasible=feasible,
        )
    return EpisodeResult(
        success=success,
        spl=spl,
        soft_spl=soft_spl,
        distance_to_goal=distance_to_goal,
        steps=steps,
        path_length=path_length,
        called_stop=called_stop,
        target_detected=target_detected,
        target_seen=target_seen,
        collisions=collisions,
        failure_cause=cause,
    )


def determine_failure_cause(
    *,
    target_detected: bool,
    false_positive: bool,
    stop_called: bool,
    target_seen: bool,
    traveled_stairs: bool,
    feasible: bool,
) -> str:
    """The reference's decision tree, full form (episode_stats_logger.py:44-72):

    target_detected -> false_positive | bad_stop_true_positive |
                       timeout_true_positive
    else            -> false_negative (target area explored, never detected) |
                       never_saw_target_{traveled_stairs|did_not_travel_stairs}
                       _{feasible|likely_infeasible}
    """
    if target_detected:
        if false_positive:
            return "false_positive"
        return "bad_stop_true_positive" if stop_called else "timeout_true_positive"
    if target_seen:
        return "false_negative"
    cause = (
        "never_saw_target_traveled_stairs"
        if traveled_stairs
        else "never_saw_target_did_not_travel_stairs"
    )
    return cause + ("_feasible" if feasible else "_likely_infeasible")


def target_bbox_px(spec, target_xy, dilate_px: int = 10):
    """Storage-layout (r0, r1, c0, c1) of the dilated target bbox — lets
    callers slice just the relevant window out of a device-resident map
    before reading it on the host (a 21x21 bool block instead of the full
    storage grid). ``spec`` is the port's ``GridSpec2D``."""
    import numpy as np
    import torch

    xy = torch.from_numpy(np.asarray(target_xy, np.float32))
    r, c = spec.to_storage(spec.xy_to_px(xy)).tolist()
    r0 = max(r - dilate_px, 0)
    c0 = max(c - dilate_px, 0)
    return r0, r + dilate_px + 1, c0, c + dilate_px + 1


def was_target_seen(explored_map, spec, target_xy, dilate_px: int = 10) -> bool:
    """Map-based 'seen' test: explored area overlaps the (dilated) target
    bbox (episode_stats_logger.py:75-81). ``explored_map`` is one lane's
    explored grid (storage layout; a numpy array or a tensor on any
    device, of which only the window is read), ``target_xy`` world meters."""
    r0, r1, c0, c1 = target_bbox_px(spec, target_xy, dilate_px)
    return bool(explored_map[r0:r1, c0:c1].any())


def was_false_positive(nav_goal_xy, target_xy, target_radius: float,
                       margin_m: float = 0.5) -> bool:
    """Nav-goal-inside-target-bbox test (episode_stats_logger.py:84-111):
    the final navigation goal must fall within the target's (margined)
    footprint to count as a true positive."""
    import numpy as np

    d = float(np.linalg.norm(np.asarray(nav_goal_xy, float)[:2]
                             - np.asarray(target_xy, float)[:2]))
    return d > target_radius + margin_m


def aggregate(results) -> dict:
    n = max(len(results), 1)
    agg = {
        "episodes": len(results),
        "success_rate": sum(r.success for r in results) / n,
        "spl": sum(r.spl for r in results) / n,
        "soft_spl": sum(r.soft_spl for r in results) / n,
        "avg_steps": sum(r.steps for r in results) / n,
    }
    causes: dict = {}
    for r in results:
        if r.failure_cause:
            causes[r.failure_cause] = causes.get(r.failure_cause, 0) + 1
    agg["failure_causes"] = causes
    return agg


def remove_numpy_arrays(d):
    """JSON-sanitize an info dict: drop ndarray values, recurse into dicts
    (episode_stats_logger.remove_numpy_arrays:114-125)."""
    import numpy as np

    if not isinstance(d, dict):
        return d
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out[k] = remove_numpy_arrays(v)
        elif not isinstance(v, np.ndarray):
            out[k] = v
    return out


def extract_scalars_from_info(info):
    """Flatten an env info dict to dotted-key scalars, skipping lists/arrays
    (vlfm_trainer.extract_scalars_from_info:40-43 role, implemented without
    habitat)."""
    import numpy as np

    out = {}

    def walk(d, prefix=""):
        for k, v in d.items():
            key = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, dict):
                walk(v, key)
            elif isinstance(v, (list, tuple, np.ndarray, str)) or v is None:
                continue
            else:
                try:
                    out[key] = float(v)
                except (TypeError, ValueError):
                    pass

    walk(info)
    return out
