"""Sparse coordinate extraction without sorts or scatters.

Counterpart of ``vlfm_tpu/ops/sparse.py``: the index of the t-th set entry
of a flat mask, for a list of t, as dense work, per lane of a batch. The
result equals cumsum + searchsorted(side="left") bit for bit.
``stratified_valid_sample`` draws its targets with jax's threefry bits
(``ops/threefry.py``), so it samples what JAX samples from the same key.
"""

from __future__ import annotations

import torch

from benchmark.frozen.ops import threefry

_LANES = 512  # chunk width for the dense t-th-set-bit selection


def _nth_set_bit_dense(mask_flat: torch.Tensor, targets: torch.Tensor):
    """Index of the ``t``-th set entry for each target t (1-based), per lane.

    mask_flat: (..., N) bool; targets: (..., T) integers, or (T,) for every
    lane. A chunked prefix (a cumsum over N/512 chunk sums), a one-hot
    product fetching each target's chunk row, and an in-row inclusive prefix
    by a triangular-ones product. Every count is an integer below 2^24 and
    every product operand is 0 or 1, so the f32 products are exact, TF32 or
    not. The exclusive prefix at the chunk is a gather: chunk prefixes can
    exceed what a reduced-precision product keeps.

    Returns (idx (..., T) int64, total (...) int64). Targets out of range (t >
    total, t < 1) give garbage, which callers mask by validity.
    """
    dev = mask_flat.device
    lead, n = mask_flat.shape[:-1], mask_flat.shape[-1]
    c = -(-n // _LANES)
    rows = torch.zeros((*lead, c * _LANES), dtype=torch.float32, device=dev)
    rows[..., :n] = mask_flat.to(torch.float32)
    rows = rows.reshape(*lead, c, _LANES)
    row_sums = rows.sum(dim=-1)  # integers as f32, exact
    chunk_prefix = torch.cumsum(row_sums, -1)  # inclusive
    total = chunk_prefix[..., -1].to(torch.int64)
    tf = targets.to(torch.float32).expand(*lead, targets.shape[-1])
    # first chunk whose inclusive prefix reaches t == count of chunks below t
    chunk_id = (chunk_prefix[..., None, :] < tf[..., :, None]).sum(dim=-1)
    safe_chunk = torch.clamp(chunk_id, max=c - 1)
    onehot = torch.nn.functional.one_hot(safe_chunk, c).to(torch.float32)
    base = torch.gather(chunk_prefix - row_sums, -1, safe_chunk)  # exclusive prefix, a gather
    row = onehot @ rows  # (..., T, LANES) 0/1
    tri = torch.triu(torch.ones((_LANES, _LANES), dtype=torch.float32, device=dev))
    row_prefix = row @ tri  # inclusive in-row prefix
    pos = (row_prefix < (tf - base)[..., None]).sum(dim=-1)
    return chunk_id * _LANES + pos, total


def first_true(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along ``dim``, the length where there is
    none (``jnp.argmax`` of a bool mask wherever a True exists)."""
    return (torch.cumsum(mask.to(torch.int32), dim=dim) == 0).sum(dim=dim)


def first_nonzero_indices(mask_flat: torch.Tensor, size: int):
    """Indices of the first ``size`` set entries of each lane's (..., N) bool
    mask.

    Returns (idx, valid), each (..., size): idx is 0 where invalid.
    """
    targets = torch.arange(1, size + 1, dtype=torch.int64, device=mask_flat.device)
    idx, total = _nth_set_bit_dense(mask_flat, targets)
    valid = targets <= total[..., None]
    return torch.where(valid, idx, 0), valid


def first_nonzero_coords(mask: torch.Tensor, size: int):
    """(rows, cols, valid) of the first ``size`` set pixels of each lane's
    (..., H, W) mask, row-major."""
    h, w = mask.shape[-2:]
    idx, valid = first_nonzero_indices(mask.reshape(*mask.shape[:-2], h * w), size)
    return idx // w, idx % w, valid


def stratified_valid_sample(mask_flat: torch.Tensor, size: int, key: torch.Tensor):
    """Up to ``size`` indices sampled uniformly (stratified, without
    replacement) among the set entries of each lane's (..., N) bool mask,
    with that lane's threefry key (..., 2).

    Target t_j = floor((j + u_j) * total / size) + 1 for u = uniform(key,
    (size,)) when total >= size, else every t in [1, total]; the t-th set
    entries come from ``_nth_set_bit_dense``. The division is exact, as in
    the JAX function; XLA may turn a division by a non-power-of-two ``size``
    into a product with its reciprocal, so exact agreement is for budgets
    that are powers of two (the object map's 512 is one).

    Returns (idx, valid), each (..., size): idx is 0 where invalid.
    """
    dev = mask_flat.device
    total0 = mask_flat.to(torch.int32).sum(dim=-1, keepdim=True, dtype=torch.int32)
    j = torch.arange(size, dtype=torch.float32, device=dev)
    u = threefry.uniform(key, (size,))
    t_strat = torch.floor((j + u) * total0.to(torch.float32) / size).to(torch.int32) + 1
    t_all = torch.arange(1, size + 1, dtype=torch.int32, device=dev)
    targets = torch.where(total0 >= size, t_strat, t_all)
    targets = torch.minimum(targets.clamp(min=1), total0.clamp(min=1))
    idx, total = _nth_set_bit_dense(mask_flat, targets)
    valid = torch.arange(size, device=dev) < total[..., None]
    return torch.where(valid, idx, 0), valid
