"""DBSCAN-style largest-cluster extraction, batched over point sets.

Counterpart of ``vlfm_tpu/ops/clustering.py`` (which replaces the Open3D
DBSCAN call, object_point_cloud_map.py:192-219): pairwise squared distances
of a fixed-size point set from one product, core points by a degree
threshold, and cluster labels from the transitive closure of the core-core
adjacency by ceil(log2 N) squarings of a 0/1 matrix. The distance product
is full f32 (the JAX version asks for ``Precision.HIGHEST``; keep TF32 off
on a GPU); the squarings' operands are 0/1 and their sums at most N, so
they are exact. Each of the (G, N, 3) point sets is one batch entry of the
products.
"""

from __future__ import annotations

import torch

from benchmark.frozen.ops.sparse import first_true


def largest_cluster_mask(
    points: torch.Tensor,  # (G, N, 3)
    valid: torch.Tensor,  # (G, N) bool
    eps: float,
    min_points: int,
) -> torch.Tensor:
    """(G, N) bool mask of each set's largest DBSCAN cluster (empty if only
    noise). Border points (non-core within eps of a core) join the cluster
    of their lowest-labelled core neighbour, matching DBSCAN semantics."""
    g, n = valid.shape
    dev = points.device
    sq = (points * points).sum(dim=-1)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.bmm(points, points.transpose(1, 2))
    eps_t = torch.full((), eps, dtype=torch.float32, device=dev)
    within = (d2 <= eps_t * eps_t) & valid[:, :, None] & valid[:, None, :]

    degree = within.sum(dim=-1)  # includes self
    core = valid & (degree >= min_points)

    core_adj = within & core[:, :, None] & core[:, None, :]
    core_adj = core_adj | (torch.eye(n, dtype=torch.bool, device=dev) & core[:, :, None])

    for _ in range(max(1, (n - 1).bit_length())):
        af = core_adj.to(torch.float32)
        core_adj = torch.bmm(af, af) > 0.5
    # jnp.argmax of a row is its first True, and 0 for a row with none.
    first = first_true(core_adj, -1)
    core_label = torch.where(core, torch.where(first < n, first, 0), n)

    # border points: label of any neighbouring core (min label)
    nb = torch.where(within & core[:, None, :], core_label[:, None, :], n)
    border_label = nb.amin(dim=-1)
    label = torch.where(core, core_label, torch.where(valid, border_label, n))

    counts = torch.zeros((g, n + 1), dtype=torch.int32, device=dev)
    counts.scatter_add_(1, label, torch.ones_like(label, dtype=torch.int32))
    counts[:, n] = 0  # noise bucket
    best = torch.argmax(counts, dim=-1, keepdim=True)
    return (label == best) & (torch.gather(counts, 1, best) > 0)
