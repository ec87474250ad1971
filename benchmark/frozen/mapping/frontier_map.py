"""V1 frontier map: one ITM cosine cached per frontier at first sight.

Counterpart of ``vlfm_tpu/mapping/frontier_map.py`` (reference:
vlfm/mapping/frontier_map.py, used by ITMPolicy V1, itm_policy.py:219-247):
each frontier is scored once, with the cosine of the image seen when it
first appeared; a stored frontier is evicted when it leaves the current
frontier list. Batch-first: (B, N, 2) positions, (B, N) cosines and valid
flags, one cache per lane. Frontiers match by exact position equality, as
the reference's ``np.array_equal`` loop; the caller supplies this step's
cosine per lane.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.frozen.device import default_device


class FrontierMapState(NamedTuple):
    positions: torch.Tensor  # (B, N, 2)
    cosines: torch.Tensor  # (B, N)
    valid: torch.Tensor  # (B, N) bool


def create(capacity: int = 64, *, batch: int = 1,
           device: torch.device | str = default_device()) -> FrontierMapState:
    return FrontierMapState(
        positions=torch.zeros((batch, capacity, 2), dtype=torch.float32, device=device),
        cosines=torch.zeros((batch, capacity), dtype=torch.float32, device=device),
        valid=torch.zeros((batch, capacity), dtype=torch.bool, device=device),
    )


def reset(state: FrontierMapState, lanes: torch.Tensor | None = None) -> FrontierMapState:
    """A cleared cache: every lane, or the lanes where the (B,) bool
    ``lanes`` is set."""
    if lanes is None:
        lanes = torch.ones(state.valid.shape[0], dtype=torch.bool, device=state.valid.device)
    return FrontierMapState(*(
        torch.where(lanes.reshape(-1, *([1] * (f.ndim - 1))), torch.zeros_like(f), f) for f in state
    ))


def matches(stored, stored_valid, frontiers, f_valid) -> torch.Tensor:
    """(B, N, F) exact-position match of each lane's stored frontiers
    (B, N, 2) against its current ones (B, F, 2)."""
    eq = (stored[:, :, None, :] == frontiers[:, None, :, :]).all(dim=-1)
    return eq & stored_valid[:, :, None] & f_valid[:, None, :]


def needs_encoding(state: FrontierMapState, frontiers, f_valid) -> torch.Tensor:
    """(B,) bool: a lane has a current frontier not yet cached
    (frontier_map.py:47-49)."""
    m = matches(state.positions, state.valid, frontiers, f_valid)
    return (f_valid & ~m.any(dim=1)).any(dim=1)


def update(
    state: FrontierMapState,
    frontiers: torch.Tensor,  # (B, F, 2)
    f_valid: torch.Tensor,  # (B, F)
    cosine: torch.Tensor,  # (B,) this step's image/text cosine
) -> FrontierMapState:
    m = matches(state.positions, state.valid, frontiers, f_valid)
    # evict stored frontiers no longer present (frontier_map.py:38-43)
    keep = state.valid & m.any(dim=2)
    # insert new frontiers with this step's cosine (frontier_map.py:46-52):
    # the j-th new frontier of a lane takes its j-th free slot
    is_new = f_valid & ~m.any(dim=1)
    free = ~keep
    new_rank = torch.cumsum(is_new.to(torch.int32), dim=1) - 1
    free_idx = torch.cumsum(free.to(torch.int32), dim=1) - 1
    assign = free[:, :, None] & is_new[:, None, :] & (free_idx[:, :, None] == new_rank[:, None, :])  # (B, N, F)
    take = assign.any(dim=2)
    src = torch.argmax(assign.to(torch.int32), dim=2)
    picked = torch.gather(frontiers, 1, src[..., None].expand(-1, -1, 2))
    positions = torch.where(take[..., None], picked, state.positions)
    cosines = torch.where(take, cosine.to(torch.float32)[:, None], state.cosines)
    return FrontierMapState(positions, cosines, keep | take)


def sort_waypoints(state: FrontierMapState):
    """Each lane's cache, descending by cosine (frontier_map.py:66-77):
    ((B, N, 2) positions, (B, N) values, (B, N) valid)."""
    v = torch.where(state.valid, state.cosines, -torch.inf)
    order = torch.argsort(-v, dim=1, stable=True)
    return (torch.gather(state.positions, 1, order[..., None].expand(-1, -1, 2)),
            torch.gather(v, 1, order), torch.gather(state.valid, 1, order))
