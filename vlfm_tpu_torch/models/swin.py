"""Swin Transformer backbone (hierarchical shifted-window attention).

Counterpart of ``vlfm_tpu/models/swin.py``: GroundingDINO's image backbone
(Swin-T, the SwinT-OGC weights of the reference's detector). A 4x4 conv
patch embedding and LayerNorm, stages of [W-MSA, SW-MSA] blocks with learned
relative-position bias tables and cyclic-shift attention masks, and 2x2
patch merging between stages. Returns the per-stage feature pyramid through
per-stage output norms.

Plain PyTorch: the JAX package runs no kernel here. Every LayerNorm is the
port's flax-style ``LayerNorm`` (f32 statistics, promoted output), GELU is
the exact erf form, and the attention softmax is f32. Submodules carry the
flax scope names (``patch_embed``, ``s{stage}_b{block}.attn.query``,
``merge{stage}.reduction``, ``out_norm{stage}``), so a JAX tree loads leaf
for leaf through ``params.load_jax_params_``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vlfm_tpu_torch.models.hf_convert import conv, dense, leaf, norm
from vlfm_tpu_torch.models.layers import Dense, LayerNorm
from vlfm_tpu_torch.models.tinyvit import conv_nhwc


@dataclass(frozen=True)
class SwinConfig:
    patch_size: int = 4
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    heads: Tuple[int, ...] = (3, 6, 12, 24)
    window: int = 7
    mlp_ratio: float = 4.0
    eps: float = 1e-5

    @staticmethod
    def tiny_test() -> "SwinConfig":
        return SwinConfig(embed_dim=16, depths=(2, 2), heads=(2, 4), window=4)


def relative_position_index(w: int) -> np.ndarray:
    """(w^2, w^2) indices into the ((2w-1)^2, heads) bias table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, w^2, w^2)
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int64)


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, w^2, C), windows in row-major order."""
    b, h, wd, c = x.shape
    x = x.reshape(b, h // w, w, wd // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, c)


def window_reverse(win: torch.Tensor, w: int, h: int, wd: int) -> torch.Tensor:
    b = win.shape[0] // (h // w * wd // w)
    x = win.reshape(b, h // w, wd // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, wd, -1)


def shift_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """(nW, w^2, w^2) additive attention mask for shifted windows: -100
    between tokens of regions the cyclic shift brought together. A host
    constant, as in the JAX module."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = (
        img.reshape(h // window, window, w // window, window)
        .transpose(0, 2, 1, 3)
        .reshape(-1, window * window)
    )
    return (win[:, None, :] != win[:, :, None]).astype(np.float32) * -100.0


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax's ``padding="SAME"`` for one axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SwinAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, *, device=None):
        super().__init__()
        self.heads = heads
        self.query = Dense(dim, dim, device=device)
        self.key = Dense(dim, dim, device=device)
        self.value = Dense(dim, dim, device=device)
        self.out = Dense(dim, dim, device=device)
        self.rel_bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 2, heads, device=device))
        self.register_buffer("rel_index", torch.from_numpy(relative_position_index(window)).to(device),
                             persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:  # (nW*B, w^2, C)
        nwb, l, c = x.shape
        hd = c // self.heads

        def split(t):
            return t.reshape(nwb, l, self.heads, hd).transpose(1, 2)

        q = split(self.query(x)) * (hd**-0.5)
        k = split(self.key(x))
        v = split(self.value(x))
        logits = torch.matmul(q, k.transpose(-1, -2))
        bias = self.rel_bias_table[self.rel_index].permute(2, 0, 1)[None]
        logits = logits + bias.to(torch.promote_types(logits.dtype, bias.dtype))
        if mask is not None:
            nw = mask.shape[0]
            logits = logits.reshape(-1, nw, self.heads, l, l) + mask[None, :, None]
            logits = logits.reshape(nwb, self.heads, l, l)
        p = torch.softmax(logits.to(torch.float32), dim=-1).to(x.dtype)
        o = torch.matmul(p, v).transpose(1, 2).reshape(nwb, l, c)
        return self.out(o)


class SwinBlock(nn.Module):
    def __init__(self, cfg: SwinConfig, dim: int, heads: int, shifted: bool, *, device=None):
        super().__init__()
        self.cfg, self.shifted = cfg, shifted
        self.ln1 = LayerNorm(dim, cfg.eps, device=device)
        self.attn = SwinAttention(dim, heads, cfg.window, device=device)
        self.ln2 = LayerNorm(dim, cfg.eps, device=device)
        hidden = int(dim * cfg.mlp_ratio)
        self.mlp_fc1 = Dense(dim, hidden, device=device)
        self.mlp_fc2 = Dense(hidden, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, C)
        b, h, w, _ = x.shape
        # HF semantics: when the map is no larger than the window, one
        # unshifted window covers it.
        win = min(self.cfg.window, h, w)
        if win != self.cfg.window:
            # The JAX module sizes this block's bias table by the shrunk
            # window at init; the port's table has the configured size.
            raise ValueError(f"a {h}x{w} map is smaller than the {self.cfg.window}-window")
        shift = win // 2 if (self.shifted and (h > win or w > win)) else 0
        y = self.ln1(x)
        ph, pw = (win - h % win) % win, (win - w % win) % win
        y = F.pad(y, (0, 0, 0, pw, 0, ph))
        hp, wp = h + ph, w + pw
        mask = None
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = torch.from_numpy(shift_mask(hp, wp, win, shift)).to(y.device)
        wins = self.attn(window_partition(y, win), mask)
        y = window_reverse(wins, win, hp, wp)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y[:, :h, :w]
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(self.ln2(x))))
        return x + y


class PatchMerging(nn.Module):
    def __init__(self, cfg: SwinConfig, dim: int, *, device=None):
        super().__init__()
        self.norm = LayerNorm(4 * dim, cfg.eps, device=device)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, C) -> (B, H/2, W/2, 2C)
        _, h, w, _ = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        y = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(y))


class SwinBackbone(nn.Module):
    """``out_stages`` (default all) are the stages whose normed features
    the caller reads; only they have an ``out_norm``, as HF's backbone
    keeps a norm for its ``out_features`` only, and the others' features
    come back as None."""

    def __init__(self, cfg: SwinConfig, out_stages: Optional[Sequence[int]] = None, *, device=None):
        super().__init__()
        self.cfg = c = cfg
        self.out_stages = tuple(range(len(c.depths)) if out_stages is None else out_stages)
        self.patch_embed = nn.Conv2d(3, c.embed_dim, c.patch_size, c.patch_size, device=device)
        self.embed_norm = LayerNorm(c.embed_dim, c.eps, device=device)
        dim = c.embed_dim
        for si, depth in enumerate(c.depths):
            for bi in range(depth):
                self.add_module(f"s{si}_b{bi}", SwinBlock(c, dim, c.heads[si], bi % 2 == 1, device=device))
            if si in self.out_stages:
                self.add_module(f"out_norm{si}", LayerNorm(dim, c.eps, device=device))
            if si < len(c.depths) - 1:
                self.add_module(f"merge{si}", PatchMerging(c, dim, device=device))
                dim *= 2

    def forward(self, images: torch.Tensor) -> List[Optional[torch.Tensor]]:
        """(B, H, W, 3) -> per-stage NHWC feature maps (normed), None for a
        stage not in ``out_stages``."""
        c = self.cfg
        p = c.patch_size
        (t, bt), (l, r) = (same_padding(n, p, p) for n in images.shape[1:3])
        x = F.pad(images, (0, 0, l, r, t, bt))
        x = self.embed_norm(conv_nhwc(x, self.patch_embed.weight, self.patch_embed.bias, stride=p))
        feats = []
        for si, depth in enumerate(c.depths):
            for bi in range(depth):
                x = getattr(self, f"s{si}_b{bi}")(x)
            feats.append(getattr(self, f"out_norm{si}")(x) if si in self.out_stages else None)
            if si < len(c.depths) - 1:
                x = getattr(self, f"merge{si}")(x)
        return feats


# ---------------------------------------------------------------------------
# HF conversion (SwinBackbone layout)
# ---------------------------------------------------------------------------
def convert_hf_swin(sd: Mapping[str, Any], cfg: SwinConfig) -> Dict[str, Any]:
    """A HF SwinBackbone state dict -> JAX's Swin tree."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    p: Dict[str, Any] = {
        "patch_embed": conv(sd, "embeddings.patch_embeddings.projection", bias=True),
        "embed_norm": norm(sd, "embeddings.norm"),
    }
    for si, depth in enumerate(cfg.depths):
        for bi in range(depth):
            b = f"encoder.layers.{si}.blocks.{bi}"
            p[f"s{si}_b{bi}"] = {
                "ln1": norm(sd, f"{b}.layernorm_before"),
                "ln2": norm(sd, f"{b}.layernorm_after"),
                "attn": {
                    "query": dense(sd, f"{b}.attention.self.query", bias=None),
                    "key": dense(sd, f"{b}.attention.self.key", bias=None),
                    "value": dense(sd, f"{b}.attention.self.value", bias=None),
                    "out": dense(sd, f"{b}.attention.output.dense", bias=None),
                    "rel_bias_table": leaf(sd[f"{b}.attention.self.relative_position_bias_table"]),
                },
                "mlp_fc1": dense(sd, f"{b}.intermediate.dense", bias=None),
                "mlp_fc2": dense(sd, f"{b}.output.dense", bias=None),
            }
        if si < len(cfg.depths) - 1:
            p[f"merge{si}"] = {
                "norm": norm(sd, f"encoder.layers.{si}.downsample.norm"),
                "reduction": dense(sd, f"encoder.layers.{si}.downsample.reduction", bias=False),
            }
        if f"hidden_states_norms.stage{si + 1}.weight" in sd:
            p[f"out_norm{si}"] = norm(sd, f"hidden_states_norms.stage{si + 1}")
    return p
