"""Multi-scale deformable gather + combine: the CUDA kernel (K4) and its
plain version.

Counterpart of ``vlfm_tpu/ops/deform_gather.py:gather_combine`` (the Pallas
TPU kernel) as the JAX package calls it from
``models/grounding_dino.py:_deform_combine_levels``, and of that module's
default formulation (``_bilinear_sample_rows`` per level, then one einsum),
which computes the same function. For each (batch, query, head) it samples
every level's value map at P points with ``grid_sample(bilinear,
padding_mode="zeros", align_corners=False)`` semantics and sums the samples
weighted by the softmaxed attention weights:

    out[b, q, h] = sum_l sum_p weights[b, q, h, l, p] *
                   bilinear(value_l[b, :, :, h], grids[b, q, h, l, p])

``value`` is the (B, S, nh*dh) flattened pyramid (S = sum of H_l * W_l,
levels in order), ``grids`` (B, Q, nh, nl, P, 2) f32 in [-1, 1] as (x, y),
``weights`` (B, Q, nh, nl, P). The result is (B, Q, nh, dh) f32.

``deform_gather`` routes by the device of ``value``: CPU tensors take
``deform_gather_ref``, a port of the JAX default formulation (the
zero-padded 2x2 patch table, the stencil anchors, one row gather per level,
then the einsum); CUDA tensors launch ``csrc/deform_gather.cu``, which
samples ``value`` directly (a GPU gathers natively, so the table that stores
each value row four times is not built), or the call raises. There is no
fallback from the kernel to the plain version.

``deform_plan`` chooses the kernel's launch from the shapes, dtypes and
pointer alignments alone: the widest tap load (up to 16 bytes) that divides
the head and the value pointer, the lanes per (b, q, h) item, the tile of
items per block, the 16-sample template or the run-time loop, whether grids
and weights reach shared memory by bulk copies, the persistent grid (its
blocks take every grid-th tile) and the shared memory. The kernel refuses a
plan that is not legal for the tensors or whose shared-memory figure
differs from its own.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence, Tuple

import torch

from vlfm_tpu_torch.utils.profiling import count, span

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_LEVELS = 8
MAX_HEAD_DIM = 128

Shapes = Sequence[Tuple[int, int]]


def patch_table(value_l: torch.Tensor, nh: int, dh: int) -> torch.Tensor:
    """(B, H, W, nh*dh) -> (B, (H+1)(W+1), nh, 4*dh) zero-padded 2x2
    stencils, tap order (dy, dx) = (0,0), (0,1), (1,0), (1,1)."""
    b, h, w, _ = value_l.shape
    pad = torch.nn.functional.pad(value_l, (0, 0, 1, 1, 1, 1)).reshape(b, h + 2, w + 2, nh, dh)
    table = torch.stack([pad[:, :-1, :-1], pad[:, :-1, 1:], pad[:, 1:, :-1], pad[:, 1:, 1:]], dim=4)
    return table.reshape(b, (h + 1) * (w + 1), nh, 4 * dh)


def stencil_anchors(grid: torch.Tensor, h: int, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """grid (..., 2) in [-1, 1] -> (anchor (...) int64 row index into the
    patch table, tap weights (..., 4) with the padding_mode="zeros" masks)."""
    x = (grid[..., 0] + 1) * w / 2 - 0.5
    y = (grid[..., 1] + 1) * h / 2 - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = x - x0
    dy = y - y0
    # Clamped in float before the conversion: far samples must not overflow.
    anchor = ((y0.clamp(-1, h - 1) + 1) * (w + 1) + x0.clamp(-1, w - 1) + 1).to(torch.int64)

    def inside(yy, xx):
        return ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)).to(x.dtype)

    wts = torch.stack([
        (1 - dx) * (1 - dy) * inside(y0, x0),
        dx * (1 - dy) * inside(y0, x0 + 1),
        (1 - dx) * dy * inside(y0 + 1, x0),
        dx * dy * inside(y0 + 1, x0 + 1),
    ], dim=-1)
    return anchor, wts


def deform_gather_ref(value: torch.Tensor, spatial_shapes: Shapes, grids: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: per level, the stencil rows of the
    patch table gathered at the anchors and combined with the bilinear
    weights (f32), then one combine with the attention weights over (level,
    point). (B, S, nh*dh), (B, Q, nh, nl, P, 2), (B, Q, nh, nl, P) -> (B, Q,
    nh, dh) f32."""
    b, q, nh, _, npts, _ = grids.shape
    dh = value.shape[-1] // nh
    start, sampled = 0, []
    for li, (ht, wd) in enumerate(spatial_shapes):
        table = patch_table(value[:, start:start + ht * wd].reshape(b, ht, wd, nh * dh), nh, dh)
        anchor, wts = stencil_anchors(grids[:, :, :, li], ht, wd)  # (B, Q, nh, P), (B, Q, nh, P, 4)
        idx = anchor.permute(0, 1, 3, 2).reshape(b, q * npts, nh, 1).expand(-1, -1, -1, 4 * dh)
        rows = torch.gather(table, 1, idx).reshape(b, q, npts, nh, 4, dh)
        wt = torch.promote_types(wts.dtype, rows.dtype)
        sampled.append(torch.einsum("bqhpt,bqphtd->bqhpd", wts.to(wt), rows.to(wt)))
        start += ht * wd
    samp = torch.stack(sampled, dim=3)  # (B, Q, nh, nl, P, dh)
    wt = torch.promote_types(samp.dtype, weights.dtype)
    return torch.einsum("bqhlpd,bqhlp->bqhd", samp.to(wt), weights.to(wt)).to(torch.float32)


def deform_gather_tolerance(value: torch.Tensor, weights: torch.Tensor) -> float:
    """What the kernel's output may differ from ``deform_gather_ref``'s by,
    absolutely. Both sum in f32 in another order (the kernel weighs the four
    taps and the level-point samples in sequence; the plain version in
    einsums), and the sampling positions may round differently in the last
    f32 ulp: a few f32 ulps of sum_lp |w| * max |value|."""
    scale = float(weights.abs().sum(dim=(-1, -2)).max()) * float(value.abs().max())
    return 1e-5 * max(scale, 1.0)


def _check_cuda_args(value, spatial_shapes, grids, weights) -> None:
    for name, t in (("grids", grids), ("weights", weights)):
        if t.device != value.device:
            raise ValueError(f"{name} is on {t.device}, value on {value.device}")
        if not t.is_contiguous():
            raise ValueError(f"deform_gather kernel takes a contiguous {name}")
    if not value.is_contiguous():
        raise ValueError("deform_gather kernel takes a contiguous value")
    if value.dtype not in _DTYPE_CODES or weights.dtype not in _DTYPE_CODES:
        raise TypeError(f"deform_gather kernel takes float32 or bfloat16 value and weights, "
                        f"got {value.dtype} and {weights.dtype}")
    if grids.dtype != torch.float32:
        raise TypeError(f"deform_gather kernel takes float32 grids, got {grids.dtype}")
    if value.ndim != 3 or grids.ndim != 6 or grids.shape[-1] != 2 or weights.ndim != 5:
        raise ValueError("deform_gather kernel takes value (B, S, nh*dh), grids (B, Q, nh, nl, P, 2) "
                         "and weights (B, Q, nh, nl, P)")
    b, q, nh, nl, npts, _ = grids.shape
    if tuple(weights.shape) != (b, q, nh, nl, npts):
        raise ValueError(f"weights {tuple(weights.shape)} do not match grids {tuple(grids.shape)}")
    if len(spatial_shapes) != nl or not 1 <= nl <= MAX_LEVELS:
        raise ValueError(f"deform_gather kernel takes 1 <= nl <= {MAX_LEVELS} levels matching the grids, "
                         f"got {len(spatial_shapes)} shapes for nl={nl}")
    if value.shape[0] != b or value.shape[1] != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"value {tuple(value.shape)} does not hold B={b} and the levels {list(spatial_shapes)}")
    if value.shape[2] % nh or not 1 <= value.shape[2] // nh <= MAX_HEAD_DIM:
        raise ValueError(f"deform_gather kernel takes nh*dh channels with 1 <= dh <= {MAX_HEAD_DIM}, "
                         f"got {value.shape[2]} for nh={nh}")
    if value.numel() >= 2**31 or grids.numel() >= 2**31:
        raise ValueError("deform_gather kernel takes fewer than 2^31 elements per tensor")


# The kernel's launch geometry (vlfm_tpu_torch/csrc/deform_gather.cu).
_WARP = 32
_BLOCKS_PER_SM = 2  # its __launch_bounds__: 8 warps, at most 128 registers a thread
_WARPS_PER_SM = 8 * _BLOCKS_PER_SM  # what the register file holds at that figure
_SMEM_PER_SM = 233472  # an H100 SM's shared memory, 1 KB of it reserved per block
_SMEM_CAP = _SMEM_PER_SM // _BLOCKS_PER_SM - 1024
SAMPLE_TEMPLATE = 16  # nl * P that the unrolled body takes: GroundingDINO's 4 levels x 4 points
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class DeformPlan:
    """How the kernel runs one call: ``vec`` elements per tap load
    (``load_bytes`` bytes), ``lanes`` lanes per (b, q, h) item with
    ``chunks`` loads each per tap, ``warps`` warps a block, ``tile_items``
    items a tile, the sample loop ("16" unrolled or "generic"), whether
    whole tiles' grids and weights arrive by bulk copies, the persistent
    grid of blocks, and the dynamic shared memory of a block."""

    vec: int
    load_bytes: int
    lanes: int
    chunks: int
    warps: int
    tile_items: int
    samples: str
    bulk: bool
    grid: int
    smem_bytes: int

    @property
    def items_per_warp(self) -> int:
        return _WARP // self.lanes

    @property
    def block(self) -> int:
        return self.warps * _WARP

    def describe(self) -> str:
        return (f"{self.load_bytes}-byte taps, {self.lanes} lanes x {self.chunks} an item, "
                f"{self.items_per_warp} items a warp, {self.tile_items} a tile, {self.samples}-sample loop, "
                f"grids and weights by {'bulk copies' if self.bulk else 'thread loads'}, "
                f"{self.grid} blocks x {self.block} threads, {self.smem_bytes} B shared")


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def alignment(ptr: int) -> int:
    """The largest power of two up to 16 that divides ``ptr``."""
    return 16 if ptr % 16 == 0 else ptr & -ptr


def deform_plan(b: int, q: int, nh: int, dh: int, nl: int, npts: int, value_dtype: torch.dtype,
                weight_dtype: torch.dtype, value_align: int, *, tables_align: int = 16,
                sms: int = H100_SMS) -> DeformPlan:
    """The kernel's launch plan. ``value_align`` and ``tables_align`` are
    the alignments (``alignment``) of the value pointer and of the grids and
    weights pointers; ``sms`` the card's multiprocessors. The shared-memory
    figure is the kernel's ``smem_bytes``."""
    esize, wsize = torch.finfo(value_dtype).bits // 8, torch.finfo(weight_dtype).bits // 8
    vec = 16 // esize
    while vec > 1 and (dh % vec or value_align % (vec * esize)):
        vec //= 2
    nvec = dh // vec
    lanes = 1
    while lanes < min(nvec, _WARP):
        lanes *= 2
    chunks = 1
    while lanes * chunks < nvec:
        chunks *= 2
    nlp = nl * npts
    for warps in (8, 4, 2, 1):
        tile = warps * _WARP // lanes
        ts = tile * nlp
        bulk = tables_align % 16 == 0 and ts * 8 % 16 == 0 and ts * wsize % 16 == 0
        smem = 16 + 64 * ts + (2 * (_align16(ts * 8) + _align16(ts * wsize)) if bulk else 0)
        if smem <= _SMEM_CAP:
            break
    else:
        raise ValueError(f"deform_gather kernel: {nlp} samples per item need {smem} bytes of shared memory")
    tiles = -(-(b * q * nh) // tile)
    per_sm = max(1, min(_WARPS_PER_SM // warps, _SMEM_PER_SM // (smem + 1024)))
    return DeformPlan(
        vec=vec, load_bytes=vec * esize, lanes=lanes, chunks=chunks, warps=warps, tile_items=tile,
        samples=str(SAMPLE_TEMPLATE) if nlp == SAMPLE_TEMPLATE else "generic", bulk=bulk,
        grid=max(1, min(tiles, sms * per_sm)), smem_bytes=smem,
    )


def plan_for(value: torch.Tensor, grids: torch.Tensor, weights: torch.Tensor) -> DeformPlan:
    """``deform_plan`` for these CUDA tensors: their shapes, dtypes and
    pointers, and their card's multiprocessors."""
    b, q, nh, nl, npts, _ = grids.shape
    return deform_plan(b, q, nh, value.shape[2] // nh, nl, npts, value.dtype, weights.dtype,
                       alignment(value.data_ptr()),
                       tables_align=min(alignment(grids.data_ptr()), alignment(weights.data_ptr())),
                       sms=torch.cuda.get_device_properties(value.device).multi_processor_count)


def deform_gather(value: torch.Tensor, spatial_shapes: Shapes, grids: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """(B, S, nh*dh) value, level shapes, (B, Q, nh, nl, P, 2) f32 grids and
    (B, Q, nh, nl, P) weights -> (B, Q, nh, dh) f32.

    CPU tensors take ``deform_gather_ref``. CUDA tensors launch the kernel on
    the current stream with ``deform_plan``'s launch, all levels in one
    launch; the counter ``K4.launches`` counts those launches. Each call
    is a ``vlfm.K4`` span with its shapes and dtype.
    """
    with span("vlfm.K4", value=value, grids=grids):
        if value.device.type == "cpu":
            return deform_gather_ref(value, spatial_shapes, grids, weights)
        if value.device.type != "cuda":
            raise ValueError(f"deform_gather runs on CPU or CUDA tensors, got {value.device}")
        from vlfm_tpu_torch.kernels.build import load_library

        _check_cuda_args(value, spatial_shapes, grids, weights)
        b, q, nh, nl, npts, _ = grids.shape
        dh = value.shape[2] // nh
        out = torch.empty((b, q, nh, dh), dtype=torch.float32, device=value.device)
        if out.numel() == 0:
            return out
        lib = load_library()
        plan = plan_for(value, grids, weights)
        levels = (ctypes.c_int * (2 * nl))(*(n for hw in spatial_shapes for n in hw))
        err = lib.vlfm_deform_gather(
            value.data_ptr(), grids.data_ptr(), weights.data_ptr(), out.data_ptr(), levels, nl,
            b, value.shape[1], q, nh, dh, npts, _DTYPE_CODES[value.dtype], _DTYPE_CODES[weights.dtype],
            plan.vec, plan.lanes, plan.chunks, plan.warps, SAMPLE_TEMPLATE if plan.samples != "generic" else 0,
            int(plan.bulk), plan.grid, plan.smem_bytes, torch.cuda.current_stream(value.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"deform_gather kernel launch failed: cudaError {err}")
        count("K4.launches")
        return out
