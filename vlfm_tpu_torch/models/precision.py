"""Serving-precision cast for a loaded model.

Counterpart of ``vlfm_tpu/models/precision.py``. Checkpoints load f32, and a
``Dense`` computes in the promoted type of activation and weight, so f32
weights would keep every matmul in f32 even with ``compute_dtype=bfloat16``.
``cast_for_serving`` casts floating-point parameters to the serving dtype,
EXCEPT those under a normalization scope and those named ``scale``: norm
gains and biases multiply f32 statistics inside the LayerNorm kernel, which
takes them in f32.
"""

from __future__ import annotations

import torch
from torch import nn

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
    return it. Parameters under a norm scope or named ``scale``, and
    non-float parameters, keep their dtype."""
    for name, param in module.named_parameters():
        path = tuple(name.split("."))
        if not param.is_floating_point() or path[-1] == "scale" or _is_norm_scope(path):
            continue
        param.data = param.data.to(dtype)
    return module
