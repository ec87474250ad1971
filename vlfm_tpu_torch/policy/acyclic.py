"""Device-resident acyclic enforcer.

Counterpart of ``vlfm_tpu/policy/acyclic.py`` (reference:
vlfm/policy/utils/acyclic_enforcer.py). States (position, chosen frontier,
top-two values) are quantized to millimetres and kept in a fixed-capacity
ring buffer; membership is a vectorized comparison.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

CAPACITY = 512
_QUANT = 1000.0  # millimetre quantization


class AcyclicState(NamedTuple):
    keys: torch.Tensor  # (CAP, 6) int32 quantized (pos, frontier, top2)
    count: torch.Tensor  # () int32


def create(capacity: int = CAPACITY, *, device: torch.device | str = "cpu") -> AcyclicState:
    return AcyclicState(
        keys=torch.zeros((capacity, 6), dtype=torch.int32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def _quant(v: torch.Tensor) -> torch.Tensor:
    return torch.round(v * _QUANT).to(torch.int32)


def _key(position, frontier, top_two) -> torch.Tensor:
    return _quant(torch.cat([position[:2], frontier[:2], top_two[:2]]))


def check_cyclic(state: AcyclicState, position, frontier, top_two) -> torch.Tensor:
    k = _key(position, frontier, top_two)
    cap = state.keys.shape[0]
    valid = torch.arange(cap, device=state.keys.device) < state.count
    return ((state.keys == k).all(dim=1) & valid).any()


def check_cyclic_batch(state: AcyclicState, position, frontiers, top_two) -> torch.Tensor:
    """Cyclic flag for each of (F, 2) candidate frontiers at one position."""
    cap = state.keys.shape[0]
    f = frontiers.shape[0]
    keys = torch.cat(
        [
            _quant(position[:2]).expand(f, 2),
            _quant(frontiers[:, :2]),
            _quant(top_two[:2]).expand(f, 2),
        ],
        dim=1,
    )  # (F, 6)
    valid = torch.arange(cap, device=state.keys.device) < state.count
    eq = (state.keys[None, :, :] == keys[:, None, :]).all(dim=2)  # (F, CAP)
    return (eq & valid[None, :]).any(dim=1)


def add(state: AcyclicState, position, frontier, top_two) -> AcyclicState:
    """Return a new state with the key appended (the input is not mutated)."""
    k = _key(position, frontier, top_two)
    cap = state.keys.shape[0]
    slot = (state.count % cap).to(torch.int64)
    keys = state.keys.clone()
    keys[slot] = k
    return AcyclicState(keys=keys, count=state.count + 1)
