"""Geodesic flood fill and dense connected-component labelling.

Counterpart of ``vlfm_tpu/ops/flood.py``: the device-side replacements for
the reference's cv2.findContours + pointPolygonTest + drawContours idiom
("keep the explored region that contains the agent",
obstacle_map.py:128-146) and for contour-area filtering of small regions.

Both are label propagation with a bounded loop over a batch of lanes
(``(B, H, W)`` masks). The JAX package runs them in a ``lax.while_loop``,
vmapped over episodes; here they are Python loops with the same
``max_iters`` and the same check cadence, and each check is one host read
for all lanes together (a ``vlfm.wait.flood`` or ``vlfm.wait.label`` span;
the counter ``map.sweeps`` adds each check's sweeps). The loop runs until
every lane has converged or ``max_iters`` is reached: a converged lane is a
fixed point, so the sweeps other lanes still need leave it unchanged, and
every lane's count of sweeps advances alike, as under vmap.
"""

from __future__ import annotations

import torch

from vlfm_tpu_torch.ops.morphology import dilate, max_pool_downsample, upsample_nearest
from vlfm_tpu_torch.ops.sparse import first_nonzero_indices
from vlfm_tpu_torch.utils.profiling import count, span

_BIG = torch.iinfo(torch.int32).max


def flood_from_seed(
    mask: torch.Tensor, seed: torch.Tensor, max_iters: int = 1024, check_every: int = 16
) -> torch.Tensor:
    """Pixels of ``mask`` 8-connected to ``seed`` (both (B, H, W) bool).

    Dilate-and-intersect until nothing changes, at most ``max_iters``
    sweeps. When the column count is a multiple of 32 the sweeps run
    bit-packed (``ops/bitpack.py``); convergence is checked every
    ``check_every`` sweeps.
    """
    from vlfm_tpu_torch.ops.bitpack import flood_packed, pack_cols, unpack_cols

    if mask.shape[-1] % 32 == 0:
        out_p = flood_packed(pack_cols(mask), pack_cols(seed), max_iters=max_iters, check_every=check_every)
        return unpack_cols(out_p, mask.shape[-1])

    cur = seed & mask
    i = 0
    while i < max_iters:
        nxt = cur
        for _ in range(check_every):
            nxt = dilate(nxt, 3) & mask
        with span("vlfm.wait.flood"):
            changed = bool((nxt != cur).any())
        cur = nxt
        i += check_every
        count("map.sweeps", check_every)
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
    return _min3(_min3(labels, -1), -2)


def label_components(mask: torch.Tensor, max_iters: int) -> torch.Tensor:
    """8-connected components by min-linear-index propagation.

    Returns (B, H, W) int32 labels (the smallest linear index within the
    lane of the component) for set pixels and INT32_MAX elsewhere. Exact for
    components whose geodesic radius from their min-index pixel is at most
    ``max_iters``; the loop runs 4 sweeps per check and stops once every
    lane has converged.
    """
    h, w = mask.shape[-2:]
    idx = torch.arange(h * w, dtype=torch.int32, device=mask.device).reshape(h, w)
    big = torch.full((), _BIG, dtype=torch.int32, device=mask.device)
    cur = torch.where(mask, idx, big)
    i = 0
    while i < max_iters:
        nxt = cur
        for _ in range(4):
            nxt = torch.where(mask, torch.minimum(nxt, _min_label_step(nxt)), big)
        with span("vlfm.wait.label"):
            changed = bool((nxt != cur).any())
        cur = nxt
        i += 4
        count("map.sweeps", 4)
        if not changed:
            break
    return cur


def _lane_offsets(flat: torch.Tensor, n: int) -> torch.Tensor:
    """(B, N) per-lane indices into a (B * n,) table."""
    return flat + torch.arange(flat.shape[0], device=flat.device)[:, None] * n


def component_sizes(labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-pixel size of the component each pixel belongs to: ones added
    into a flat per-lane (H*W,) table at each pixel's label, then gathered
    back. Labels must be linear indices (from ``label_components``)."""
    b, h, w = labels.shape
    flat = labels.reshape(b, -1).to(torch.int64)
    m = mask.reshape(b, -1)
    safe = _lane_offsets(torch.where(m, flat, 0), h * w)
    counts = torch.zeros(b * h * w, dtype=torch.int32, device=labels.device)
    counts.index_add_(0, safe.reshape(-1), m.to(torch.int32).reshape(-1))
    sizes = torch.gather(counts.reshape(b, -1), 1, flat.clamp(0, h * w - 1)).reshape(b, h, w)
    return torch.where(mask, sizes, 0)


def remove_small_components_coarse(
    mask: torch.Tensor,
    area_thresh_px: float | torch.Tensor,
    factor: int = 4,
    max_iters: int = 512,
    max_roots: int = 128,
) -> torch.Tensor:
    """Drop components of each lane's ``mask`` (B, H, W) whose area is below
    ``area_thresh_px``.

    Labelling runs ``factor``x coarser (max-pooled), so components closer
    than ``factor`` px may merge, and areas count coarse cells * factor^2.
    Sizes are counted for the first ``max_roots`` component roots in index
    order; components beyond them are kept, as are pieces of regions whose
    labelling did not converge in ``max_iters``. The JAX version compares
    every cell with every root (an (R, N) reduction); counting the cells of
    each label and looking the small roots up gives the same mask.
    """
    dev = mask.device
    coarse = max_pool_downsample(mask, factor)
    b = coarse.shape[0]
    labels = label_components(coarse, max_iters)
    flat = labels.reshape(b, -1).to(torch.int64)
    cflat = coarse.reshape(b, -1)
    n = flat.shape[1]
    roots = (flat == torch.arange(n, device=dev)) & cflat
    root_idx, rvalid = first_nonzero_indices(roots, max_roots)
    counts = torch.zeros(b * n, dtype=torch.int64, device=dev)
    counts.index_add_(0, _lane_offsets(torch.where(cflat, flat, 0), n).reshape(-1),
                      cflat.to(torch.int64).reshape(-1))
    sizes = torch.where(rvalid, torch.gather(counts.reshape(b, n), 1, root_idx), 0)
    thresh = area_thresh_px.to(torch.float32) if torch.is_tensor(area_thresh_px) else torch.full(
        (), area_thresh_px, dtype=torch.float32, device=dev)
    small = rvalid & (sizes.to(torch.float32) * (factor * factor) < thresh)
    # One table of n + 1 labels per lane; entry n takes the roots not small.
    small_label = torch.zeros(b * (n + 1), dtype=torch.bool, device=dev)
    small_label.index_fill_(0, _lane_offsets(torch.where(small, root_idx, n), n + 1).reshape(-1), True)
    drop = cflat & torch.gather(small_label.reshape(b, n + 1), 1, torch.where(cflat, flat, n))
    keep = coarse & ~drop.reshape(coarse.shape)
    return mask & upsample_nearest(keep, factor)
