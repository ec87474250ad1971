"""Shared transformer building blocks as ``nn.Module``s.

Counterpart of ``vlfm_tpu/models/layers.py``. Submodule and parameter names
follow the flax scopes (``ln``, ``qkv``, ``proj``, ``query``, ``fc1``, ...)
so a JAX parameter tree maps onto these modules name for name (see
``blip2_itm.from_jax_params``).

Compute policy: parameters may be stored f32 or bf16; a ``Dense`` computes
in the promoted type of its input and weight, as flax's ``nn.Dense`` does.
LayerNorm statistics are f32 (the CUDA kernel in ``ops/norms.py``, or the
plain ``LayerNorm`` where the JAX package uses flax's ``nn.LayerNorm``); the
attention softmax is f32 (the ViT's attention on the card is the CUDA kernel
in ``ops/attention.py``); GELU is the exact erf form.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vlfm_tpu_torch.ops.attention import attention as fused_attention, qkv_views
from vlfm_tpu_torch.ops.norms import layer_norm


class Dense(nn.Linear):
    """``nn.Linear`` that computes in ``promote_types(input, weight)``, as
    flax's ``nn.Dense`` promotes a bf16 activation against an f32 kernel.
    ``bias=False`` is flax's ``use_bias=False``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Norm(nn.Module):
    """Base of the port's norm layers. Their ``weight`` holds the flax
    ``scale`` leaf, which ``precision.cast_for_serving`` keeps in f32."""


class FastLayerNorm(Norm):
    """Drop-in ``nn.LayerNorm`` over the last axis (same ``weight``/``bias``
    parameters) with f32 statistics, routed through ``ops.norms.layer_norm``:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class LayerNorm(Norm):
    """Counterpart of flax's ``nn.LayerNorm`` (plain PyTorch; the JAX package
    runs no kernel for it): f32 statistics with flax's fast variance
    E[x^2] - E[x]^2 clipped at 0, and ``(x - mean) * (rsqrt(var + eps) *
    weight) + bias`` in f32. The result takes ``promote_types(x, weight,
    bias)`` as in flax, so f32 norm parameters lift a bf16 stream to f32;
    with ``keep_dtype`` it is cast back to x's dtype instead, as when the
    JAX package casts a block's parameters to the compute dtype
    (``tinyvit_fast.encode_fused``)."""

    def __init__(self, dim: int, eps: float = 1e-6, *, keep_dtype: bool = False, device=None):
        super().__init__()
        self.eps = eps
        self.keep_dtype = keep_dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        mu = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
        y = (xf - mu) * (torch.rsqrt(var + self.eps) * self.weight.to(torch.float32))
        y = y + self.bias.to(torch.float32)
        if self.keep_dtype:
            return y.to(x.dtype)
        return y.to(torch.promote_types(torch.promote_types(x.dtype, self.weight.dtype), self.bias.dtype))


class LayerNormF32(nn.Module):
    """LayerNorm computed in f32, cast back to the input dtype. Holds its norm
    as ``ln``, like the flax scope."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device=None):
        super().__init__()
        self.ln = FastLayerNorm(dim, eps, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln(x)


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """(B, H, Lq, D) x (B, H, Lk, D) -> (B, H, Lq, D).

    Logits in the input dtype, softmax in f32, probabilities cast back to the
    input dtype for the second product. ``mask`` (broadcastable bool, True =
    attend) sets masked logits to -1e30.
    """
    d = q.shape[-1]
    logits = torch.matmul(q, k.transpose(-1, -2)).to(torch.float32) / math.sqrt(d)
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


class FusedQKVAttention(nn.Module):
    """CLIP/EVA-style attention with one fused qkv projection.

    q, k and v reach attention as strided views of the projection. On CUDA
    tensors attention is the K3 kernel (``ops.attention``) in its
    max-subtracted, probability-normalised form, the function of the JAX
    package's ``attention`` off the TPU; the kernel writes (B, L, H, D)
    memory, so merging the heads is a view. On CPU tensors it is the plain
    ``attention`` above.
    """

    def __init__(self, dim: int, num_heads: int, *, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, device=device)
        self.proj = Dense(dim, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = qkv_views(self.qkv(x), self.num_heads)
        out = attention(q, k, v) if x.device.type == "cpu" else fused_attention(q, k, v)
        return self.proj(merge_heads(out))


class BertAttention(nn.Module):
    """BERT-style attention with separate q/k/v, optional cross-attention."""

    def __init__(self, dim: int, num_heads: int, kv_dim: Optional[int] = None, *, device=None):
        super().__init__()
        kv_dim = dim if kv_dim is None else kv_dim
        self.num_heads = num_heads
        self.query = Dense(dim, dim, device=device)
        self.key = Dense(kv_dim, dim, device=device)
        self.value = Dense(kv_dim, dim, device=device)
        self.out = Dense(dim, dim, device=device)

    def forward(
        self, x: torch.Tensor, kv: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        kv = x if kv is None else kv
        h = self.num_heads
        out = attention(
            split_heads(self.query(x), h),
            split_heads(self.key(kv), h),
            split_heads(self.value(kv), h),
            mask=mask,
        )
        return self.out(merge_heads(out))


class MLP(nn.Module):
    """fc1 -> exact-erf GELU -> fc2."""

    def __init__(self, dim: int, hidden: int, *, device=None):
        super().__init__()
        self.fc1 = Dense(dim, hidden, device=device)
        self.fc2 = Dense(hidden, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))
