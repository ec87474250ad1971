"""TinyViT image encoder, MobileSAM's backbone, as served on the GPU.

Counterpart of ``vlfm_tpu/models/tinyvit.py`` (the flax ``TinyViT``) and of
``vlfm_tpu/models/tinyvit_fast.py:encode_fused`` (its serving path) in one
module; there is no separate fast module. Reference: mobile_sam
tiny_vit_5m as served by vlfm/vlm/sam.py:24-57.

- Patch embed: two stride-2 3x3 convs (1024 -> 256 px), GELU between.
- Stage 0: MBConv blocks (1x1 expand 4x -> depthwise 3x3 -> 1x1 project,
  residual, GELU) through ``ops.conv_fused.mbconv_chain``: the K2 kernel
  for CUDA tensors, as ``encode_fused`` runs the Pallas kernel.
- PatchMerging between stages: 1x1 -> depthwise 3x3 -> 1x1. The merges
  into stages 1 and 2 have stride 2 and run as plain strided ``F.conv2d``
  (the JAX package's space-to-depth rewrite of them is a TPU workaround);
  the merge into the last stage has stride 1 and runs through
  ``mbconv_chain``.
- Stages 1..3: window attention with learned per-offset biases, a depthwise
  3x3 local conv, an MLP.
- SAM neck: 1x1 conv -> LayerNorm2d -> 3x3 conv -> LayerNorm2d.

BatchNorms are folded into the convs (``ConvBN`` is a biased conv). Layouts
are NHWC at every module boundary, as in JAX; the torch weights are OIHW,
and the MBConv chains re-lay them out for the kernel (w1 (Cin, Ch), w2
(3, 3, Ch), w3 (Ch, Cout)).

Precision: with ``compute_dtype`` set, images are cast to it and every
block computes in it, as ``encode_fused`` does after casting each block's
parameters: the blocks' LayerNorms return the activation dtype. GELU is
the exact erf form everywhere (``encode_fused`` uses ``gelu_poly`` on the
TPU). The neck's LayerNorm2d follows flax's promotion, so f32 norm
parameters give an f32 embedding, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.frozen.models.layers import Dense, LayerNorm
from benchmark.frozen.ops.conv_fused import mbconv_chain


@dataclass(frozen=True)
class TinyViTConfig:
    img_size: int = 1024
    embed_dims: Tuple[int, ...] = (64, 128, 160, 320)  # tiny_vit_5m
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (2, 4, 5, 10)
    window_sizes: Tuple[int, ...] = (7, 7, 14, 7)
    mlp_ratio: float = 4.0
    mbconv_expand: float = 4.0
    out_channels: int = 256  # SAM neck output
    compute_dtype: Optional[torch.dtype] = None  # e.g. torch.bfloat16; softmax stays f32

    @staticmethod
    def tiny() -> "TinyViTConfig":
        return TinyViTConfig(
            img_size=64,
            embed_dims=(8, 12, 16, 20),
            depths=(1, 1, 2, 1),
            num_heads=(2, 2, 2, 2),
            window_sizes=(2, 2, 4, 2),
            out_channels=16,
        )


def conv_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
              stride: int = 1, padding: int = 0, groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` on an NHWC tensor with an OIHW weight, computed in
    ``promote_types(x, weight)`` as flax's ``nn.Conv``. The result is a
    contiguous NHWC tensor (cuDNN may return NCHW memory), as the MBConv
    kernel takes it."""
    dt = torch.promote_types(x.dtype, weight.dtype)
    y = F.conv2d(
        x.permute(0, 3, 1, 2).to(dt), weight.to(dt), None if bias is None else bias.to(dt),
        stride=stride, padding=padding, groups=groups,
    )
    return y.permute(0, 2, 3, 1).contiguous()


class ConvBN(nn.Module):
    """Conv with folded BatchNorm (the bias carries the BN statistics)."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1, groups: int = 1,
                 *, device=None):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2, groups=groups, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        return conv_nhwc(x, c.weight, c.bias, c.stride[0], c.padding[0], c.groups)


def chain_weights(conv1: ConvBN, conv2: ConvBN, conv3: ConvBN, dt: torch.dtype):
    """A ConvBN triplet as ``mbconv_chain`` arguments: weights in the JAX
    layouts cast to the activation dtype, biases f32 (as
    ``tinyvit_fast._chain_weights``)."""
    f32 = torch.float32
    return (
        conv1.conv.weight[:, :, 0, 0].t().contiguous().to(dt), conv1.conv.bias.to(f32).contiguous(),
        conv2.conv.weight[:, 0].permute(1, 2, 0).contiguous().to(dt), conv2.conv.bias.to(f32).contiguous(),
        conv3.conv.weight[:, :, 0, 0].t().contiguous().to(dt), conv3.conv.bias.to(f32).contiguous(),
    )


class MBConv(nn.Module):
    def __init__(self, dim: int, expand: float, *, device=None):
        super().__init__()
        hidden = int(dim * expand)
        self.conv1 = ConvBN(dim, hidden, 1, device=device)
        self.conv2 = ConvBN(hidden, hidden, 3, groups=hidden, device=device)
        self.conv3 = ConvBN(hidden, dim, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = chain_weights(self.conv1, self.conv2, self.conv3, x.dtype)
        return mbconv_chain(x, *w, residual=True, final_gelu=True)


class PatchMerging(nn.Module):
    def __init__(self, cin: int, out_dim: int, stride: int, *, device=None):
        super().__init__()
        self.stride = stride
        self.conv1 = ConvBN(cin, out_dim, 1, device=device)
        self.conv2 = ConvBN(out_dim, out_dim, 3, stride=stride, groups=out_dim, device=device)
        self.conv3 = ConvBN(out_dim, out_dim, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 1:
            w = chain_weights(self.conv1, self.conv2, self.conv3, x.dtype)
            return mbconv_chain(x, *w)
        x = F.gelu(self.conv1(x))
        x = F.gelu(self.conv2(x))
        return self.conv3(x)


def attention_bias_idxs(ws: int) -> np.ndarray:
    """(N, N) index map into the unique-offset bias table (TinyViT)."""
    pts = [(i, j) for i in range(ws) for j in range(ws)]
    offsets: Dict[Tuple[int, int], int] = {}
    idxs = np.zeros((len(pts), len(pts)), np.int64)
    for a, p1 in enumerate(pts):
        for b, p2 in enumerate(pts):
            off = (abs(p1[0] - p2[0]), abs(p1[1] - p2[1]))
            if off not in offsets:
                offsets[off] = len(offsets)
            idxs[a, b] = offsets[off]
    return idxs


class TinyAttention(nn.Module):
    """TinyViT attention: q/k width key_dim, v width attn_ratio*key_dim,
    learned per-offset additive biases, pre-norm."""

    def __init__(self, dim: int, heads: int, window: int, attn_ratio: int = 1, *, device=None):
        super().__init__()
        self.heads = heads
        self.key_dim = dim // heads
        self.d = attn_ratio * self.key_dim
        idxs = attention_bias_idxs(window)
        self.norm = LayerNorm(dim, 1e-5, keep_dtype=True, device=device)
        self.qkv = Dense(dim, heads * (2 * self.key_dim + self.d), device=device)
        self.attention_biases = nn.Parameter(torch.zeros(heads, int(idxs.max()) + 1, device=device))
        self.register_buffer("bias_idxs", torch.from_numpy(idxs).to(device), persistent=False)
        self.proj = Dense(heads * self.d, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B*, N, C), N == window**2
        h, kd = self.heads, self.key_dim
        x = self.norm(x)
        qkv = self.qkv(x).reshape(*x.shape[:-1], h, 2 * kd + self.d)
        q, k, v = (t.transpose(-3, -2) for t in qkv.split([kd, kd, self.d], dim=-1))
        attn = torch.matmul(q, k.transpose(-1, -2)) * (kd**-0.5)
        attn = attn + self.attention_biases[:, self.bias_idxs]
        attn = torch.softmax(attn.to(torch.float32), dim=-1).to(x.dtype)
        out = torch.matmul(attn, v).transpose(-3, -2).reshape(*x.shape[:-1], h * self.d)
        return self.proj(out)


class TinyViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, mlp_ratio: float, *, device=None):
        super().__init__()
        self.window = window
        self.attn = TinyAttention(dim, heads, window, device=device)
        self.local_conv = ConvBN(dim, dim, 3, groups=dim, device=device)
        self.mlp_norm = LayerNorm(dim, 1e-5, keep_dtype=True, device=device)
        self.mlp_fc1 = Dense(dim, int(dim * mlp_ratio), device=device)
        self.mlp_fc2 = Dense(int(dim * mlp_ratio), dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, C)
        b, hh, ww, c = x.shape
        ws = self.window
        shortcut = x
        # pad to window multiples, partition, attend, unpartition
        ph, pw = (ws - hh % ws) % ws, (ws - ww % ws) % ws
        y = F.pad(x, (0, 0, 0, pw, 0, ph))
        hp, wp = hh + ph, ww + pw
        y = y.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        y = self.attn(y.reshape(-1, ws * ws, c))
        y = y.reshape(b, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        y = y.reshape(b, hp, wp, c)[:, :hh, :ww]
        x = shortcut + y
        x = self.local_conv(x)
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(self.mlp_norm(x))))
        return x + y


class TinyViT(nn.Module):
    """MobileSAM image encoder with the SAM neck: (B, S, S, 3) normalized
    images -> (B, S/16, S/16, out_channels). Submodules carry the flax
    scope names, so ``params.load_jax_params_`` loads a JAX tree."""

    def __init__(self, cfg: TinyViTConfig, *, device=None):
        super().__init__()
        from benchmark.frozen.models.sam import LayerNorm2d

        self.cfg = c = cfg
        n0 = c.embed_dims[0]
        self.patch_embed1 = ConvBN(3, n0 // 2, 3, stride=2, device=device)
        self.patch_embed2 = ConvBN(n0 // 2, n0, 3, stride=2, device=device)
        for i in range(c.depths[0]):
            self.add_module(f"stage0_block{i}", MBConv(n0, c.mbconv_expand, device=device))
        for s in range(1, len(c.depths)):
            stride = 2 if s < len(c.depths) - 1 else 1
            self.add_module(f"merge{s}", PatchMerging(c.embed_dims[s - 1], c.embed_dims[s], stride,
                                                      device=device))
            for i in range(c.depths[s]):
                self.add_module(f"stage{s}_block{i}", TinyViTBlock(
                    c.embed_dims[s], c.num_heads[s], c.window_sizes[s], c.mlp_ratio, device=device))
        self.neck_conv1 = nn.Conv2d(c.embed_dims[-1], c.out_channels, 1, bias=False, device=device)
        self.neck_ln1 = LayerNorm2d(c.out_channels, device=device)
        self.neck_conv2 = nn.Conv2d(c.out_channels, c.out_channels, 3, padding=1, bias=False,
                                    device=device)
        self.neck_ln2 = LayerNorm2d(c.out_channels, device=device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        if c.compute_dtype is not None:
            images = images.to(c.compute_dtype)
        x = F.gelu(self.patch_embed1(images))
        x = self.patch_embed2(x)
        for i in range(c.depths[0]):
            x = getattr(self, f"stage0_block{i}")(x)
        for s in range(1, len(c.depths)):
            x = getattr(self, f"merge{s}")(x)
            for i in range(c.depths[s]):
                x = getattr(self, f"stage{s}_block{i}")(x)
        x = self.neck_ln1(conv_nhwc(x, self.neck_conv1.weight))
        return self.neck_ln2(conv_nhwc(x, self.neck_conv2.weight, padding=1))


def chain_launches(cfg: TinyViTConfig) -> int:
    """``mbconv_chain`` calls in one ``TinyViT`` forward: the stage-0
    MBConvs and the stride-1 merge into the last stage (3 for
    tiny_vit_5m)."""
    return cfg.depths[0] + 1


# ---------------------------------------------------------------------------
# mobile_sam checkpoint conversion (BatchNorms folded into the convs)
# ---------------------------------------------------------------------------
