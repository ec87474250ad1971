"""Geodesic flood fill and dense connected-component labelling.

Counterpart of ``vlfm_tpu/ops/flood.py``: the device-side replacements for
the reference's cv2.findContours + pointPolygonTest + drawContours idiom
("keep the explored region that contains the agent",
obstacle_map.py:128-146) and for contour-area filtering of small regions.

Both are label propagation with a bounded loop. The JAX package runs them
in a ``lax.while_loop``; here they are Python loops with the same
``max_iters`` and the same check cadence, one host read per check, so they
stop after the same number of sweeps, converged or not.
"""

from __future__ import annotations

import torch

from vlfm_tpu_torch.ops.morphology import dilate, max_pool_downsample, upsample_nearest
from vlfm_tpu_torch.ops.sparse import first_nonzero_indices

_BIG = torch.iinfo(torch.int32).max


def flood_from_seed(
    mask: torch.Tensor, seed: torch.Tensor, max_iters: int = 1024, check_every: int = 16
) -> torch.Tensor:
    """Pixels of ``mask`` 8-connected to ``seed`` (both bool, same shape).

    Dilate-and-intersect until nothing changes, at most ``max_iters``
    sweeps. When the column count is a multiple of 32 the sweeps run
    bit-packed (``ops/bitpack.py``); convergence is checked every
    ``check_every`` sweeps.
    """
    from vlfm_tpu_torch.ops.bitpack import flood_packed, pack_cols, unpack_cols

    if mask.shape[1] % 32 == 0:
        out_p = flood_packed(pack_cols(mask), pack_cols(seed), max_iters=max_iters, check_every=check_every)
        return unpack_cols(out_p, mask.shape[1])

    cur = seed & mask
    i = 0
    while i < max_iters:
        nxt = cur
        for _ in range(check_every):
            nxt = dilate(nxt, 3) & mask
        changed = bool((nxt != cur).any())
        cur = nxt
        i += check_every
        if not changed:
            break
    return cur


def _min3(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Minimum over a 3-wide SAME window along ``dim``, padding with INT32_MAX."""
    n = x.shape[dim]
    pad_shape = list(x.shape)
    pad_shape[dim] = 1
    big = torch.full(pad_shape, _BIG, dtype=x.dtype, device=x.device)
    p = torch.cat([big, x, big], dim=dim)
    return torch.minimum(torch.minimum(p.narrow(dim, 0, n), p.narrow(dim, 1, n)), p.narrow(dim, 2, n))


def _min_label_step(labels: torch.Tensor) -> torch.Tensor:
    return _min3(_min3(labels, 1), 0)


def label_components(mask: torch.Tensor, max_iters: int) -> torch.Tensor:
    """8-connected components by min-linear-index propagation.

    Returns int32 labels (the smallest linear index of the component) for
    set pixels and INT32_MAX elsewhere. Exact for components whose geodesic
    radius from their min-index pixel is at most ``max_iters``; the loop
    runs 4 sweeps per check and stops once converged.
    """
    h, w = mask.shape
    idx = torch.arange(h * w, dtype=torch.int32, device=mask.device).reshape(h, w)
    big = torch.tensor(_BIG, dtype=torch.int32, device=mask.device)
    cur = torch.where(mask, idx, big)
    i = 0
    while i < max_iters:
        nxt = cur
        for _ in range(4):
            nxt = torch.where(mask, torch.minimum(nxt, _min_label_step(nxt)), big)
        changed = bool((nxt != cur).any())
        cur = nxt
        i += 4
        if not changed:
            break
    return cur


def component_sizes(labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-pixel size of the component each pixel belongs to: ones added
    into a flat (H*W,) table at each pixel's label, then gathered back.
    Labels must be linear indices (from ``label_components``)."""
    h, w = labels.shape
    flat = labels.reshape(-1).to(torch.int64)
    m = mask.reshape(-1)
    safe = torch.where(m, flat, 0)
    counts = torch.zeros(h * w, dtype=torch.int32, device=labels.device)
    counts.index_add_(0, safe, m.to(torch.int32))
    sizes = counts[flat.clamp(0, h * w - 1)].reshape(h, w)
    return torch.where(mask, sizes, 0)


def remove_small_components_coarse(
    mask: torch.Tensor,
    area_thresh_px: float | torch.Tensor,
    factor: int = 4,
    max_iters: int = 512,
    max_roots: int = 128,
) -> torch.Tensor:
    """Drop components of ``mask`` whose area is below ``area_thresh_px``.

    Labelling runs ``factor``x coarser (max-pooled), so components closer
    than ``factor`` px may merge, and areas count coarse cells * factor^2.
    Sizes are counted for the first ``max_roots`` component roots in index
    order; components beyond them are kept, as are pieces of regions whose
    labelling did not converge in ``max_iters``. The JAX version compares
    every cell with every root (an (R, N) reduction); counting the cells of
    each label and looking the small roots up gives the same mask.
    """
    coarse = max_pool_downsample(mask, factor)
    labels = label_components(coarse, max_iters)
    flat = labels.reshape(-1).to(torch.int64)
    cflat = coarse.reshape(-1)
    n = flat.shape[0]
    roots = (flat == torch.arange(n, device=mask.device)) & cflat
    root_idx, rvalid = first_nonzero_indices(roots, max_roots)
    counts = torch.zeros(n, dtype=torch.int64, device=mask.device)
    counts.index_add_(0, torch.where(cflat, flat, 0), cflat.to(torch.int64))
    sizes = torch.where(rvalid, counts[root_idx], 0)
    thresh = torch.as_tensor(area_thresh_px, dtype=torch.float32, device=mask.device)
    small = rvalid & (sizes.to(torch.float32) * (factor * factor) < thresh)
    small_label = torch.zeros(n + 1, dtype=torch.bool, device=mask.device)
    small_label[torch.where(small, root_idx, n)] = True
    drop = cflat & small_label[torch.where(cflat, flat, n)]
    keep = coarse & ~drop.reshape(coarse.shape)
    return mask & upsample_nearest(keep, factor)
