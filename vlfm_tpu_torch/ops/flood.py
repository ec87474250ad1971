"""Geodesic flood fill and dense connected-component labelling.

Counterpart of ``vlfm_tpu/ops/flood.py``: the device-side replacements for
the reference's cv2.findContours + pointPolygonTest + drawContours idiom
("keep the explored region that contains the agent",
obstacle_map.py:128-146) and for contour-area filtering of small regions.

Both are label propagation with a bounded loop over a batch of lanes
(``(B, H, W)`` masks). The JAX package runs them in a ``lax.while_loop``,
vmapped over episodes. Here a CUDA tensor runs the whole loop in one launch
of a hand-written kernel (``csrc/sweeps.cu``), which reads nothing back to
the host, so a CUDA graph can hold it; there is no fallback from the kernel. A
CPU tensor takes the plain version: a Python loop with the same
``max_iters`` and the same check cadence, each check one host read for all
lanes together (a ``vlfm.wait.flood`` or ``vlfm.wait.label`` span). The
loop runs until every lane has converged or ``max_iters`` is reached,
rounded up to a whole check: a converged lane is a fixed point, so the
sweeps other lanes still need leave it unchanged, and every lane's count of
sweeps advances alike, as under vmap. The kernel stops each lane at its
first sweep that changes nothing, or at that same cap, so both give the
same bits. The counter ``map.sweeps`` adds the plain loop's sweeps on the
host, and the kernel's (the most any lane ran) into its device accumulator
(``utils/profiling.device_counter``); the kernels count their own runs the
same way, ``flood.launches`` and ``label.launches``, so a graph's replays
count as the launches they are.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from vlfm_tpu_torch.ops.morphology import dilate, max_pool_downsample, upsample_nearest
from vlfm_tpu_torch.ops.sparse import first_nonzero_indices
from vlfm_tpu_torch.utils.profiling import count, device_counter, span

_BIG = torch.iinfo(torch.int32).max
SMEM_LIMIT = 232_448  # a block's shared memory on sm_90 (227 KB)
CLUSTER = 8  # CTAs a lane (csrc/sweeps.cu)
_FLAG_BYTES = 16
_scratch: Dict[torch.device, torch.Tensor] = {}


def sweep_cap(max_iters: int, check_every: int) -> int:
    """The most sweeps the plain loop runs: ``max_iters`` rounded up to a
    whole check (none for ``max_iters`` <= 0)."""
    return max(0, -(-max_iters // check_every) * check_every)


def sweep_plan(rows: int, row_bytes: int, buffers: int) -> Tuple[int, int]:
    """(rows a CTA, shared bytes a CTA) of a sweep kernel over a lane of
    ``rows`` rows, 8 CTAs a lane: ``buffers`` bands of rows of
    ``row_bytes`` and the flags. The obstacle map's 1024 px map (1344 rows
    of storage) takes 85 KB a CTA for the flood, 113 KB for the labelling."""
    rows_per = -(-rows // CLUSTER)
    smem = _FLAG_BYTES + rows_per * row_bytes * buffers
    if smem > SMEM_LIMIT:
        raise ValueError(f"a lane of {rows} rows of {row_bytes} bytes does not fit {CLUSTER} CTAs' shared memory")
    return rows_per, smem


@functools.cache
def _library():
    """The kernel library and the getter of a device's current stream,
    looked up once, at the first CUDA call."""
    from vlfm_tpu_torch.kernels.build import load_library

    return load_library(), torch._C._cuda_getCurrentRawStream


def _counts(dev: torch.device, launches: str) -> Tuple[int, int, int]:
    """Addresses of ``map.sweeps``' and ``launches``' accumulators and of
    the launches' scratch (two int32 zeros, cleared again by each launch) on
    ``dev``; all are made outside any graph capture."""
    scratch = _scratch.get(dev)
    if scratch is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the sweep kernels' first launch on a device lies inside a graph capture")
        scratch = _scratch[dev] = torch.zeros(2, dtype=torch.int32, device=dev)
    return (device_counter("map.sweeps", dev).data_ptr(), device_counter(launches, dev).data_ptr(),
            scratch.data_ptr())


def _as_lanes(x: torch.Tensor, name: str, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``x`` as a contiguous (lanes, rows, cols) tensor of ``dtype`` on ``device``, or raise."""
    if x.dtype != dtype:
        raise TypeError(f"the sweep kernel takes {dtype} {name}, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the mask on {device}")
    if x.dim() < 2:
        raise ValueError(f"{name} needs (..., rows, cols), got {tuple(x.shape)}")
    return x.reshape(-1, *x.shape[-2:]).contiguous()


def flood_cuda(mask: torch.Tensor, seed: torch.Tensor, cap: int, *, wrap: bool) -> torch.Tensor:
    """The flood kernel: at most ``cap`` dilate-and-mask sweeps of every
    lane of the (..., rows, cols) bool ``mask`` and ``seed``, rows and
    32-column words rolled round the grid with ``wrap``, else empty outside
    it. One launch a call."""
    dev = mask.device
    if seed.shape != mask.shape:
        raise ValueError(f"seed {tuple(seed.shape)} and mask {tuple(mask.shape)} differ")
    m, s = _as_lanes(mask, "mask", torch.bool, dev), _as_lanes(seed, "seed", torch.bool, dev)
    lanes, rows, cols = m.shape
    out = torch.empty_like(m)
    if out.numel():
        rows_per, smem = sweep_plan(rows, 4 * -(-cols // 32), 3)
        lib, raw_stream = _library()
        sweeps, launches, scratch = _counts(dev, "flood.launches")
        err = lib.vlfm_flood(m.data_ptr(), s.data_ptr(), out.data_ptr(), int(wrap), lanes, rows, cols, cap, rows_per,
                             smem, sweeps, launches, scratch, raw_stream(dev.index))
        if err != 0:
            raise RuntimeError(f"flood kernel launch failed: cudaError {err}")
    return out.reshape(mask.shape)


def label_cuda(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """The labelling kernel: at most ``cap`` sweeps of every lane of the
    (..., rows, cols) bool ``mask``; int32 labels. One launch a call."""
    dev = mask.device
    if mask.shape[-2] * mask.shape[-1] >= _BIG:
        raise ValueError(f"a lane of {mask.shape[-2]} x {mask.shape[-1]} cells has linear indices past int32")
    m = _as_lanes(mask, "mask", torch.bool, dev)
    lanes, rows, cols = m.shape
    out = torch.empty(m.shape, dtype=torch.int32, device=dev)
    if out.numel():
        rows_per, smem = sweep_plan(rows, 4 * cols, 2)
        lib, raw_stream = _library()
        sweeps, launches, scratch = _counts(dev, "label.launches")
        err = lib.vlfm_label(m.data_ptr(), out.data_ptr(), lanes, rows, cols, cap, rows_per, smem, sweeps, launches,
                             scratch, raw_stream(dev.index))
        if err != 0:
            raise RuntimeError(f"labelling kernel launch failed: cudaError {err}")
    return out.reshape(mask.shape)


def flood_from_seed(
    mask: torch.Tensor, seed: torch.Tensor, max_iters: int = 1024, check_every: int = 16
) -> torch.Tensor:
    """Pixels of ``mask`` 8-connected to ``seed`` (both (B, H, W) bool).

    Dilate-and-intersect until nothing changes, at most ``max_iters``
    sweeps. When the column count is a multiple of 32 the sweeps run
    bit-packed (``ops/bitpack.py``), rolling around the grid's edges; else
    cells outside the grid are empty. A CUDA mask runs the flood kernel on
    the bool masks (packed inside it), with the same edges; a CPU mask the
    plain loop, ``flood_from_seed_ref``.
    """
    if mask.is_cuda:
        return flood_cuda(mask, seed, sweep_cap(max_iters, check_every), wrap=mask.shape[-1] % 32 == 0)
    return flood_from_seed_ref(mask, seed, max_iters, check_every)


def flood_from_seed_ref(
    mask: torch.Tensor, seed: torch.Tensor, max_iters: int = 1024, check_every: int = 16
) -> torch.Tensor:
    """The plain version of ``flood_from_seed``: convergence is checked
    every ``check_every`` sweeps, one host read each."""
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
    lane has converged. A CUDA mask runs the labelling kernel; a CPU mask
    the plain loop, ``label_components_ref``.
    """
    if mask.is_cuda:
        return label_cuda(mask, sweep_cap(max_iters, 4))
    return label_components_ref(mask, max_iters)


def label_components_ref(mask: torch.Tensor, max_iters: int) -> torch.Tensor:
    """The plain version of ``label_components``: 4 sweeps a check, one
    host read each."""
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
