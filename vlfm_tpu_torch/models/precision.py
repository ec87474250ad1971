"""Serving-precision cast for a loaded model.

Counterpart of ``vlfm_tpu/models/precision.py``. Checkpoints load f32, and a
``Dense`` computes in the promoted type of activation and weight, so f32
weights would keep every matmul in f32 even with ``compute_dtype=bfloat16``.
``cast_for_serving`` casts floating-point parameters to the serving dtype,
EXCEPT those under a normalization scope and the flax ``scale`` leaves: norm
gains and biases multiply f32 statistics inside the LayerNorm kernel, which
takes them in f32. The rule is the JAX package's, leaf for leaf. The port
stores a flax ``scale`` as the ``weight`` of a norm module
(``layers.Norm``), so that is the leaf kept here; a norm whose scope does
not read as one (SAM's ``neck_ln1``) keeps its scale f32 and has its bias
cast, as in JAX.
"""

from __future__ import annotations

import torch
from torch import nn

from vlfm_tpu_torch.models.layers import Norm

# Scope-name fragments (matched case-insensitively against every component of
# the parameter path) whose parameters keep their dtype: "ln", "ln1",
# "post_ln", "self_ln", "norm", "bn", "rms", ...
_NORM_FRAGMENTS = ("ln", "norm", "bn", "rms")


def _is_norm_scope(path: tuple[str, ...]) -> bool:
    for name in path:
        low = name.lower()
        if any(
            low == f or low.startswith(f"{f}_") or low.endswith(f"_{f}")
            or low.startswith(f) and low[len(f):].isdigit()
            for f in _NORM_FRAGMENTS
        ):
            return True
    return False


@torch.no_grad()
def cast_for_serving(module: nn.Module, dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Cast ``module``'s floating-point parameters to ``dtype`` in place and
    return it. Parameters under a norm scope, norm scales, and non-float
    parameters keep their dtype."""
    scales = {
        f"{prefix}.weight" if prefix else "weight"
        for prefix, mod in module.named_modules() if isinstance(mod, Norm)
    }
    for name, param in module.named_parameters():
        path = tuple(name.split("."))
        if not param.is_floating_point() or name in scales or _is_norm_scope(path):
            continue
        param.data = param.data.to(dtype)
    return module
