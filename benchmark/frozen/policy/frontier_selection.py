"""Best-frontier selection: value sort + stickiness + acyclic suppression.

Counterpart of ``vlfm_tpu/policy/frontier_selection.py`` (reference:
BaseITMPolicy._get_best_frontier, itm_policy.py:76-152):

1. sort frontiers by value, descending (stable);
2. if the previously pursued frontier (or one within 0.5 m of it) is still
   present and its value is within 0.01 of the previous value, stick to it;
3. otherwise take the best frontier whose (position, frontier, top-two
   values) state-action is not in the acyclic history;
4. if every candidate is cyclic, fall back to the frontier FARTHEST from the
   robot;
5. record the chosen state-action and the value for the next step.

Branch-free tensor code over a batch of lanes, each with its own
frontiers, robot, last choice and acyclic history, so nothing here waits on
the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.frozen.policy import acyclic as AC


class FrontierChoice(NamedTuple):
    frontier: torch.Tensor  # (B, 2)
    value: torch.Tensor  # (B,)
    any_valid: torch.Tensor  # (B,) bool
    acyclic: AC.AcyclicState
    last_value: torch.Tensor
    last_frontier: torch.Tensor


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none), as
    ``jnp.argmax`` on bools."""
    return torch.argmax(mask.to(torch.int32), dim=-1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for (B, F[, D]) x and (B,) idx."""
    if x.ndim == 2:
        return torch.gather(x, 1, idx[:, None])[:, 0]
    return torch.gather(x, 1, idx[:, None, None].expand(-1, 1, x.shape[-1]))[:, 0]


def select_best_frontier(
    frontiers: torch.Tensor,  # (B, F, 2) world meters
    valid: torch.Tensor,  # (B, F) bool
    values: torch.Tensor,  # (B, F) reduced per-frontier values
    robot_xy: torch.Tensor,  # (B, 2)
    last_frontier: torch.Tensor,  # (B, 2) zeros sentinel = none
    last_value: torch.Tensor,  # (B,)
    acyclic_state: AC.AcyclicState,
) -> FrontierChoice:
    dev = frontiers.device
    any_valid = valid.any(dim=-1)

    v = torch.where(valid, values, -torch.inf)
    order = torch.argsort(-v, dim=-1, stable=True)
    sorted_pts = torch.gather(frontiers, 1, order[..., None].expand(-1, -1, 2))
    sorted_vals = torch.gather(v, 1, order)
    sorted_valid = torch.gather(valid, 1, order)

    # pad like tuple(sorted_values[:2]) with <2 frontiers
    top_two = torch.where(torch.arange(2, device=dev) < valid.sum(dim=-1, keepdim=True), sorted_vals[:, :2], 0.0)

    have_last = torch.any(last_frontier != 0.0, dim=-1)
    # exact match first, else closest within 0.5 m (itm_policy.py:101-115)
    exact = sorted_valid & torch.all(sorted_pts == last_frontier[:, None], dim=-1)
    d_last = torch.where(
        sorted_valid, torch.linalg.vector_norm(sorted_pts - last_frontier[:, None], dim=-1), torch.inf
    )
    close_idx = torch.argmin(d_last, dim=-1)
    has_close = _take(d_last, close_idx) <= 0.5
    exact_idx = _first_true(exact)
    has_exact = exact.any(dim=-1)
    curr_index = torch.where(has_exact, exact_idx, close_idx)
    has_curr = have_last & (has_exact | has_close)

    stick = has_curr & (_take(sorted_vals, curr_index) + 0.01 > last_value)

    # best non-cyclic candidate in sorted order (itm_policy.py:128-135)
    cyclic = AC.check_cyclic_batch(acyclic_state, robot_xy, sorted_pts, top_two)
    cand = sorted_valid & ~cyclic
    noncyc_idx = _first_true(cand)
    has_noncyc = cand.any(dim=-1)

    # fallback: farthest frontier from the robot (itm_policy.py:137-143)
    dist_robot = torch.where(
        valid, torch.linalg.vector_norm(frontiers - robot_xy[:, None], dim=-1), -torch.inf
    )
    far_idx = torch.argmax(dist_robot, dim=-1)

    use_sorted_idx = torch.where(stick, curr_index, noncyc_idx)
    use_sorted = stick | has_noncyc
    best_frontier = torch.where(use_sorted[:, None], _take(sorted_pts, use_sorted_idx), _take(frontiers, far_idx))
    best_value = torch.where(use_sorted, _take(sorted_vals, use_sorted_idx), _take(v, far_idx))

    new_acyclic = AC.add(acyclic_state, robot_xy, best_frontier, top_two)
    return FrontierChoice(
        frontier=best_frontier,
        value=best_value,
        any_valid=any_valid,
        acyclic=new_acyclic,
        last_value=best_value,
        last_frontier=best_frontier,
    )


def reduce_values_v3(values: torch.Tensor, valid: torch.Tensor, exploration_thresh: float) -> torch.Tensor:
    """ITMPolicyV3 dual-channel reduction (itm_policy.py:296-316): per lane,
    use the target channel unless its best value is below the exploration
    threshold, in which case fall back to the exploration channel. values
    (B, F, 2), valid (B, F)."""
    target = values[..., 0]
    explore = values[..., 1]
    max_target = torch.amax(torch.where(valid, target, -torch.inf), dim=-1, keepdim=True)
    return torch.where(max_target < exploration_thresh, explore, target)
