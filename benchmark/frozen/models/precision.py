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

``exact_f32`` runs a block's f32 convolutions and matmuls on the card
without TF32, for the models the JAX package keeps in f32 (PointNav).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from benchmark.frozen.models.layers import Norm

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


@contextlib.contextmanager
def exact_f32(device: torch.device | str):
    """Turn TF32 off for cuBLAS and cuDNN inside the block when ``device``
    is a card, whatever the caller set, and give the caller's flags back
    after it. cuDNN's other flags (enabled, benchmark, its limit,
    deterministic) keep the caller's values. On the CPU it does nothing."""
    if torch.device(device).type != "cuda":
        yield
        return
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    # The per-backend getter, where this PyTorch has it, reads the flag
    # whichever API set it; the legacy getter raises after the newer API.
    before = getattr(matmul, "fp32_precision", None) or ("tf32" if matmul.allow_tf32 else "ieee")
    matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, benchmark_limit=cudnn.benchmark_limit,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        if before in ("ieee", "tf32"):
            matmul.allow_tf32 = before == "tf32"
        else:
            matmul.fp32_precision = before
