"""Pre-LN ViT vision encoder (CLIP/EVA family), HF Blip2VisionModel layout.

Counterpart of ``vlfm_tpu/models/vit.py``: the EVA-CLIP ViT-g/14 backbone of
BLIP-2 (fused qkv, learned class + position embeddings, pre-LN blocks,
post-layernorm output). Images come in channels-last, (B, H, W, 3), as in
the JAX version.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.frozen.models.layers import MLP, FusedQKVAttention, LayerNormF32


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1408
    depth: int = 39
    heads: int = 16
    mlp_dim: int = 6144
    ln_eps: float = 1e-6

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, *, device=None):
        super().__init__()
        self.ln1 = LayerNormF32(cfg.width, cfg.ln_eps, device=device)
        self.attn = FusedQKVAttention(cfg.width, cfg.heads, device=device)
        self.ln2 = LayerNormF32(cfg.width, cfg.ln_eps, device=device)
        self.mlp = MLP(cfg.width, cfg.mlp_dim, device=device)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One pre-LN block on the residual stream ``x + h``, whose add is
        still to be made; returns the next stream as such a pair. Each add
        runs in the launch of the norm after it."""
        x, y = self.ln1(x, h, keep_sum=True)
        x, y = self.ln2(x, self.attn(y), keep_sum=True)
        return x, self.mlp(y)


class ViTEncoder(nn.Module):
    def __init__(self, cfg: ViTConfig, *, device=None):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.patch_embed = nn.Conv2d(
            3, c.width, c.patch_size, stride=c.patch_size, device=device
        )
        self.class_embedding = nn.Parameter(torch.zeros(c.width, device=device))
        self.position_embedding = nn.Parameter(
            torch.zeros(c.num_patches + 1, c.width, device=device)
        )
        for i in range(c.depth):
            self.add_module(f"block{i}", ViTBlock(c, device=device))
        self.post_ln = LayerNormF32(c.width, c.ln_eps, device=device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) float in model scale -> (B, 1 + patches, width)."""
        c = self.cfg
        conv = self.patch_embed
        dt = torch.promote_types(images.dtype, conv.weight.dtype)
        x = F.conv2d(
            images.permute(0, 3, 1, 2).to(dt), conv.weight.to(dt), conv.bias.to(dt),
            stride=c.patch_size,
        )  # (B, width, h, w)
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)  # (B, h*w, width), row-major patches
        cls = self.class_embedding.to(x.dtype).expand(b, 1, c.width)
        x = torch.cat([cls, x], dim=1)
        # The stream is carried as a pair (x, h) whose sum is still to be
        # made: the position add folds into block 0's ln1, each block's
        # closing add into the next block's ln1 and the last into post_ln.
        h = self.position_embedding[None].to(x.dtype)
        for i in range(c.depth):
            x, h = getattr(self, f"block{i}")(x, h)
        return self.post_ln(x, h)
