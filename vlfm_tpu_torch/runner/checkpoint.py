"""Checkpoint and resume of episodic state and model parameters.

Counterpart of ``vlfm_tpu/runner/checkpoint.py``. The reference's
"checkpointing" is a dummy policy file and episode-level JSON resume; its
map state cannot be restored mid-episode. Here the whole policy state (every
map, the recurrence, the acyclic memory, the counters) is a tree of
NamedTuples of tensors, so a mid-episode snapshot is one file, and the same
two calls serve a model's ``state_dict`` and a batched multi-episode
state. The file is ``torch.save`` of a flat {path: CPU tensor} dict, read
back with ``torch.load(weights_only=True)``: no pickled code. The round trip
is bit for bit.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Dict

import torch


def map_tensors(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``tree`` with ``fn`` applied to every tensor leaf. Trees are
    NamedTuples, tuples, lists and dicts; other leaves come back as they
    are."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    if isinstance(tree, dict):
        return type(tree)((k, map_tensors(fn, v)) for k, v in tree.items())
    return tree


def _items(tree: Any, prefix: str = ""):
    """(path, leaf) of every leaf, the path joined from field names, dict
    keys and list positions with "/"."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _items(v, f"{prefix}{name}/")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _items(v, f"{prefix}{i}/")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def save_pytree(path: str, tree: Any) -> str:
    """Save every tensor of ``tree`` (a PolicyState, a model's
    ``state_dict``, a batched state) to the file ``path``; returns its
    absolute path."""
    p = Path(path).absolute()
    flat: Dict[str, torch.Tensor] = {k: v.detach().cpu() for k, v in _items(tree) if torch.is_tensor(v)}
    torch.save(flat, p)
    return str(p)


def restore_pytree(path: str, like: Any) -> Any:
    """A tree saved by ``save_pytree``. ``like`` (e.g. a freshly created
    state) supplies the structure, and each tensor's dtype and device; a
    leaf that is not a tensor is ``like``'s own. A missing tensor or a
    shape that differs from ``like``'s raises."""
    flat = torch.load(Path(path).absolute(), map_location="cpu", weights_only=True)
    keys = iter([k for k, v in _items(like) if torch.is_tensor(v)])  # map_tensors' order

    def take(want: torch.Tensor) -> torch.Tensor:
        key = next(keys)
        if key not in flat:
            raise KeyError(f"{path} has no tensor at {key!r}")
        got = flat[key]
        if got.shape != want.shape:
            raise ValueError(f"{key}: saved shape {tuple(got.shape)}, expected {tuple(want.shape)}")
        return got.to(dtype=want.dtype, device=want.device)

    return map_tensors(take, like)
