"""The check's samples: which decisions, and their state kept on the host."""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def sample_indices(seed: int, n: int, within: int) -> List[int]:
    """Decision 0 (the start, from a fresh state) and ``n - 1`` more drawn
    from the seed among decisions 1 .. within - 1."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    return [0] + sorted(int(i) for i in rng.choice(np.arange(1, within), size=n - 1, replace=False))


def host_copy(tree):
    """An empty pinned host twin of a tensor tree (NamedTuples of tensors)."""
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, pin_memory=tree.is_cuda)
    return type(tree)(*(host_copy(t) for t in tree))


def copy_into(dst, src) -> None:
    if isinstance(src, torch.Tensor):
        dst.copy_(src, non_blocking=True)
        return
    for d, s in zip(dst, src):
        copy_into(d, s)
