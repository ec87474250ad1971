"""Frontier detection: the boundary between explored space and unexplored
navigable space, grouped into segments, one waypoint per segment.

Counterpart of ``vlfm_tpu/ops/frontier.py`` (the algorithm the reference
delegates to ``frontier_exploration``, obstacle_map.py:155-169):

1. dilate the explored area 5x5 so 1-2 px gaps against walls are not
   frontiers (obstacle_map.py:159-163),
2. drop unexplored pockets below the area threshold,
3. frontier cells = unexplored navigable cells next to the explored area,
4. group the first ``max_cells`` frontier cells into 8-connected segments
   by the transitive closure of their adjacency matrix, taken by repeated
   squaring of a (P, P) 0/1 f32 matrix. Its entries and sums are integers
   up to P, so the products are exact in TF32 as in f32,
5. waypoint = the segment member nearest the segment centroid.

When the column count is a multiple of 32 the dilations and the frontier
mask run bit-packed, as in JAX. Every step runs on a batch of lanes, each
with its own grids; the closure is one batched (B, P, P) product per
squaring.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.frozen.ops.bitpack import (
    dilate8_packed,
    first_set_bits_packed,
    invert,
    pack_cols,
    popcount,
    unpack_cols,
)
from benchmark.frozen.ops.flood import remove_small_components_coarse
from benchmark.frozen.ops.morphology import dilate
from benchmark.frozen.ops.sparse import first_nonzero_coords, first_nonzero_indices, first_true


class Frontiers(NamedTuple):
    waypoints_px: torch.Tensor  # (B, F, 2) float32 (row, col)
    valid: torch.Tensor  # (B, F) bool
    sizes: torch.Tensor  # (B, F) int64 segment pixel counts
    overflow: torch.Tensor  # (B,) bool: more than P frontier cells existed


def _cluster_sparse(coords: torch.Tensor, valid: torch.Tensor, num_closure_steps: int) -> torch.Tensor:
    """Labels (smallest member index) of 8-connected clusters among sparse
    points. coords: (B, P, 2) int; valid: (B, P)."""
    p = coords.shape[1]
    cheb = (coords[:, :, None, :] - coords[:, None, :, :]).abs().amax(dim=-1)
    adj = (cheb <= 1) & valid[:, :, None] & valid[:, None, :]
    adj = adj | torch.eye(p, dtype=torch.bool, device=coords.device)
    for _ in range(num_closure_steps):
        af = adj.to(torch.float32)
        adj = torch.bmm(af, af) > 0.5
    return first_true(adj, -1)  # the diagonal is set, so a column is found


def _first_min(x: torch.Tensor, dim: int) -> torch.Tensor:
    """jnp.argmin: the first index of the minimum along ``dim``."""
    return first_true(x == x.amin(dim=dim, keepdim=True), dim)


def detect_frontiers(
    navigable: torch.Tensor,  # (B, S, S) bool
    explored: torch.Tensor,  # (B, S, S) bool
    area_thresh_px: float | torch.Tensor,  # px^2
    *,
    max_cells: int = 512,
    max_frontiers: int = 32,
    coarse_factor: int = 4,
) -> Frontiers:
    dev = explored.device
    b, cols_total = explored.shape[0], explored.shape[-1]
    packed = cols_total % 32 == 0
    if packed:
        expl_d_p = dilate8_packed(dilate8_packed(pack_cols(explored)))  # 5x5
        unexplored = unpack_cols(pack_cols(navigable) & invert(expl_d_p), cols_total)
    else:
        unexplored = navigable & ~dilate(explored, 5)
    # max_iters bounds the coarse labelling: pockets below any realistic area
    # threshold converge within ~thresh/factor^2 iterations.
    unexplored = remove_small_components_coarse(
        unexplored, area_thresh_px, factor=coarse_factor, max_iters=48
    )
    if packed:
        frontier_p = pack_cols(unexplored) & dilate8_packed(expl_d_p)
        rows, cols, valid = first_set_bits_packed(frontier_p, max_cells)
        n_frontier = popcount(frontier_p).reshape(b, -1).sum(dim=1)
    else:
        frontier_mask = unexplored & dilate(dilate(explored, 5), 3)
        rows, cols, valid = first_nonzero_coords(frontier_mask, max_cells)
        n_frontier = frontier_mask.reshape(b, -1).sum(dim=1)
    coords = torch.stack([rows, cols], dim=-1)
    coords = torch.where(valid[..., None], coords, -1)
    overflow = n_frontier > max_cells

    # ceil(log2(max_cells)) squarings give the full closure for any diameter
    steps = max(1, (max_cells - 1).bit_length())
    labels = _cluster_sparse(coords, valid, steps)

    roots = valid & (labels == torch.arange(max_cells, device=dev))
    root_idx, f_valid = first_nonzero_indices(roots, max_frontiers)
    root_idx = torch.where(f_valid, root_idx, -1)

    member = labels[:, None, :] == root_idx[:, :, None].clamp(min=0)  # (B, F, P)
    member = member & valid[:, None, :] & f_valid[:, :, None]
    sizes = member.sum(dim=-1)

    cf = coords.to(torch.float32)
    centroid = (member[..., None] * cf[:, None]).sum(dim=2) / torch.clamp(sizes, min=1)[..., None].to(torch.float32)
    diff = cf[:, None] - centroid[:, :, None]
    d2 = (diff * diff).sum(dim=-1)
    d2 = torch.where(member, d2, torch.inf)
    pick = _first_min(d2, -1)  # (B, F)
    picked = torch.gather(cf, 1, pick[..., None].expand(b, max_frontiers, 2))
    waypoints = torch.where(f_valid[..., None], picked, -1.0)
    return Frontiers(waypoints_px=waypoints, valid=f_valid, sizes=sizes, overflow=overflow)
