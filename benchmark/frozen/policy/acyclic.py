"""Device-resident acyclic enforcer.

Counterpart of ``vlfm_tpu/policy/acyclic.py`` (reference:
vlfm/policy/utils/acyclic_enforcer.py). States (position, chosen frontier,
top-two values) are quantized to millimetres and kept in a fixed-capacity
ring buffer per lane; membership is a vectorized comparison.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.frozen.device import default_device

CAPACITY = 512
_QUANT = 1000.0  # millimetre quantization


class AcyclicState(NamedTuple):
    keys: torch.Tensor  # (B, CAP, 6) int32 quantized (pos, frontier, top2)
    count: torch.Tensor  # (B,) int32


def create(capacity: int = CAPACITY, *, batch: int = 1,
           device: torch.device | str = default_device()) -> AcyclicState:
    return AcyclicState(
        keys=torch.zeros((batch, capacity, 6), dtype=torch.int32, device=device),
        count=torch.zeros(batch, dtype=torch.int32, device=device),
    )


def _quant(v: torch.Tensor) -> torch.Tensor:
    return torch.round(v * _QUANT).to(torch.int32)


def _key(position, frontier, top_two) -> torch.Tensor:
    """(B, 6) keys from (B, 2) positions, frontiers and top-two values."""
    return _quant(torch.cat([position[..., :2], frontier[..., :2], top_two[..., :2]], dim=-1))


def _live(state: AcyclicState) -> torch.Tensor:
    """(B, CAP) mask of the ring entries each lane has written."""
    cap = state.keys.shape[1]
    return torch.arange(cap, device=state.keys.device) < state.count[:, None]


def check_cyclic(state: AcyclicState, position, frontier, top_two) -> torch.Tensor:
    """(B,) flag: each lane's state-action is in its history."""
    k = _key(position, frontier, top_two)
    return ((state.keys == k[:, None, :]).all(dim=-1) & _live(state)).any(dim=-1)


def check_cyclic_batch(state: AcyclicState, position, frontiers, top_two) -> torch.Tensor:
    """(B, F) cyclic flags for each lane's (F, 2) candidate frontiers at its
    (2,) position."""
    f = frontiers.shape[1]
    keys = torch.cat(
        [
            _quant(position[:, None, :2]).expand(-1, f, 2),
            _quant(frontiers[..., :2]),
            _quant(top_two[:, None, :2]).expand(-1, f, 2),
        ],
        dim=-1,
    )  # (B, F, 6)
    eq = (state.keys[:, None, :, :] == keys[:, :, None, :]).all(dim=-1)  # (B, F, CAP)
    return (eq & _live(state)[:, None, :]).any(dim=-1)


def add(state: AcyclicState, position, frontier, top_two) -> AcyclicState:
    """Return a new state with each lane's key appended (the input is not
    mutated)."""
    k = _key(position, frontier, top_two)
    b, cap = state.keys.shape[:2]
    slot = (state.count % cap).to(torch.int64)
    keys = state.keys.clone()
    keys[torch.arange(b, device=keys.device), slot] = k
    return AcyclicState(keys=keys, count=state.count + 1)
