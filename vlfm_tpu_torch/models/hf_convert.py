"""Leaf helpers of the checkpoint converters.

Each model module's ``convert_*`` maps a published checkpoint's state dict
(name -> numpy array) to the JAX package's parameter tree of that model,
the tree ``from_jax_params`` loads. Its leaves are numpy arrays with the
dtypes ``jnp.asarray`` would give them (JAX runs with x64 off), and
transposes stay views: ``from_jax_params`` makes the one contiguous copy
of each leaf.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np

# jnp.asarray's canonical types with x64 off
_X32 = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32,
        np.dtype(np.complex128): np.complex64}


def leaf(a: Any) -> np.ndarray:
    """``jnp.asarray(a)`` as numpy: 64-bit types become 32-bit ones, and
    any other array is returned as it is (a view stays a view)."""
    a = np.asarray(a)
    return a.astype(_X32[a.dtype]) if a.dtype in _X32 else a


def kernel(w: Any, axes=None) -> np.ndarray:
    """A torch weight re-laid out as a flax kernel: (out, in) -> (in, out),
    or a conv's OIHW -> HWIO by default."""
    w = np.asarray(w)
    if axes is None:
        axes = (1, 0) if w.ndim == 2 else (2, 3, 1, 0)
    return leaf(w.transpose(axes))


def dense(sd: Mapping[str, Any], name: str, bias: Optional[bool] = True) -> Dict[str, np.ndarray]:
    """A torch Linear as a flax Dense. ``bias``: True requires it, None
    takes it where the state dict has it, False leaves it out."""
    out = {"kernel": kernel(sd[f"{name}.weight"])}
    if bias or (bias is None and f"{name}.bias" in sd):
        out["bias"] = leaf(sd[f"{name}.bias"])
    return out


def norm(sd: Mapping[str, Any], name: str) -> Dict[str, np.ndarray]:
    """A torch LayerNorm (or GroupNorm) as flax's ``scale`` and ``bias``."""
    return {"scale": leaf(sd[f"{name}.weight"]), "bias": leaf(sd[f"{name}.bias"])}


def conv(sd: Mapping[str, Any], name: str, bias: Optional[bool] = None, axes=(2, 3, 1, 0)) -> Dict[str, np.ndarray]:
    """A torch Conv2d (or, with other ``axes``, a ConvTranspose2d) as a
    flax Conv; ``bias`` as in ``dense``, taken where present by default."""
    out = {"kernel": kernel(sd[f"{name}.weight"], axes)}
    if bias or (bias is None and f"{name}.bias" in sd):
        out["bias"] = leaf(sd[f"{name}.bias"])
    return out
