"""Sparse coordinate extraction without sorts or scatters.

Counterpart of ``vlfm_tpu/ops/sparse.py``: the index of the t-th set entry
of a flat mask, for a fixed list of t, as dense work. The result equals
cumsum + searchsorted(side="left") bit for bit.
``stratified_valid_sample`` is not ported yet: it needs jax's threefry bits
and waits for the object map.
"""

from __future__ import annotations

import torch

_LANES = 512  # chunk width for the dense t-th-set-bit selection


def _nth_set_bit_dense(mask_flat: torch.Tensor, targets: torch.Tensor):
    """Index of the ``t``-th set entry for each target t (1-based).

    A chunked prefix (a cumsum over n/512 chunk sums), a one-hot product
    fetching each target's chunk row, and an in-row inclusive prefix by a
    triangular-ones product. Every count is an integer below 2^24 and every
    product operand is 0 or 1, so the f32 products are exact, TF32 or not.
    The exclusive prefix at the chunk is a gather: chunk prefixes can exceed
    what a reduced-precision product keeps.

    Returns (idx (T,) int64, total () int64). Targets out of range (t >
    total, t < 1) give garbage, which callers mask by validity.
    """
    dev = mask_flat.device
    n = mask_flat.shape[0]
    c = -(-n // _LANES)
    rows = torch.zeros(c * _LANES, dtype=torch.float32, device=dev)
    rows[:n] = mask_flat.to(torch.float32)
    rows = rows.reshape(c, _LANES)
    row_sums = rows.sum(dim=1)  # integers as f32, exact
    chunk_prefix = torch.cumsum(row_sums, 0)  # inclusive
    total = chunk_prefix[-1].to(torch.int64)
    tf = targets.to(torch.float32)
    # first chunk whose inclusive prefix reaches t == count of chunks below t
    chunk_id = (chunk_prefix[None, :] < tf[:, None]).sum(dim=1)
    safe_chunk = torch.clamp(chunk_id, max=c - 1)
    onehot = torch.nn.functional.one_hot(safe_chunk, c).to(torch.float32)
    base = (chunk_prefix - row_sums)[safe_chunk]  # exclusive prefix, a gather
    row = onehot @ rows  # (T, LANES) 0/1
    tri = torch.triu(torch.ones((_LANES, _LANES), dtype=torch.float32, device=dev))
    row_prefix = row @ tri  # inclusive in-row prefix
    pos = (row_prefix < (tf - base)[:, None]).sum(dim=1)
    return chunk_id * _LANES + pos, total


def first_true(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along ``dim``, the length where there is
    none (``jnp.argmax`` of a bool mask wherever a True exists)."""
    return (torch.cumsum(mask.to(torch.int32), dim=dim) == 0).sum(dim=dim)


def first_nonzero_indices(mask_flat: torch.Tensor, size: int):
    """Indices of the first ``size`` set entries of a flat bool tensor.

    Returns (idx, valid): idx is 0 where invalid.
    """
    targets = torch.arange(1, size + 1, dtype=torch.int64, device=mask_flat.device)
    idx, total = _nth_set_bit_dense(mask_flat, targets)
    valid = targets <= total
    return torch.where(valid, idx, 0), valid


def first_nonzero_coords(mask: torch.Tensor, size: int):
    """(rows, cols, valid) of the first ``size`` set pixels (row-major)."""
    h, w = mask.shape
    idx, valid = first_nonzero_indices(mask.reshape(-1), size)
    return idx // w, idx % w, valid
