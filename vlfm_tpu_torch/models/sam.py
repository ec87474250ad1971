"""Promptable segmentation (the SAM family) as batched GPU inference.

Counterpart of ``vlfm_tpu/models/sam.py`` (reference: the MobileSAM
server, vlfm/vlm/sam.py:24-57, one ``segment_bbox(image, xyxy)`` call per
box). The image is encoded once per frame and all boxes of all frames
decode in one batched call; gated segmentation runs only the frames that
hold a detection, in passes of a fixed frame capacity.

Two image encoders sit behind the same prompt encoder and mask decoder, as
in JAX: the ViT-det encoder of ``facebook/sam-vit-base`` (``SamConfig()``,
``SamConfig.tiny()``: windowed attention with decomposed relative
positions, periodic global blocks, a conv + LayerNorm2d neck), and
MobileSAM's TinyViT (``SamConfig.mobile_sam()``, whose conv stages run the
K2 kernel). ``cfg.tinyvit is None`` selects ViT-det.

Submodules carry the flax scope names (``vision``, ``shared_pe``,
``prompt``, ``decoder.layer0.cross_t2i``, ``vision.block0.attn``, ...), so
``SAM.from_jax_params`` loads a JAX tree of either encoder through
``params.load_jax_params_``.

Precision mirrors flax's promotion: the decoder runs in the embedding's
dtype, and a norm with f32 parameters lifts a bf16 stream to f32. With
``cast_for_serving`` the neck's LayerNorm2d keeps an f32 scale, so the
embedding and the decoder are f32 behind a bf16 encoder, as in JAX. The
ViT-det encoder runs in f32 throughout under ``cast_for_serving`` (its
blocks' LayerNorms keep f32 parameters and every bf16 Dense promotes), with
plain PyTorch LayerNorm and attention as the JAX module has them, and TF32
off on the card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vlfm_tpu_torch.device import default_device
from vlfm_tpu_torch.models.hf_convert import conv, dense, leaf, norm
from vlfm_tpu_torch.models.layers import Dense, LayerNorm, Norm, promoted
from vlfm_tpu_torch.models.params import init_random_, load_jax_params_
from vlfm_tpu_torch.models.precision import exact_f32
from vlfm_tpu_torch.models.tinyvit import (
    TinyViT, TinyViTConfig, conv_nhwc, convert_mobile_sam_encoder, expected_mobile_sam_keys)
from vlfm_tpu_torch.ops.resize import resize_matmul
from vlfm_tpu_torch.utils.profiling import count, span


@dataclass(frozen=True)
class SamVisionConfig:
    image_size: int = 1024
    patch_size: int = 16
    width: int = 768
    depth: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    out_channels: int = 256

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


@dataclass(frozen=True)
class SamDecoderConfig:
    hidden: int = 256
    layers: int = 2
    heads: int = 8
    mlp_dim: int = 2048
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden: int = 256
    downsample_rate: int = 2


@dataclass(frozen=True)
class SamConfig:
    vision: SamVisionConfig = field(default_factory=SamVisionConfig)
    decoder: SamDecoderConfig = field(default_factory=SamDecoderConfig)
    pe_dim: int = 128  # half of the prompt hidden width
    # MobileSAM: TinyViT in place of the ViT-det encoder; vision.image_size
    # and out_channels must agree with it. None is sam-vit-base's ViT-det.
    tinyvit: Optional[TinyViTConfig] = None

    @staticmethod
    def mobile_sam() -> "SamConfig":
        """MobileSAM (vit_t): TinyViT-5M at 1024 px, bf16, and the standard
        SAM decoder."""
        tv = TinyViTConfig(compute_dtype=torch.bfloat16)
        return SamConfig(
            vision=SamVisionConfig(image_size=tv.img_size, patch_size=16, out_channels=tv.out_channels),
            tinyvit=tv,
        )

    @staticmethod
    def tiny_mobile_sam() -> "SamConfig":
        tv = TinyViTConfig.tiny()
        return SamConfig(
            vision=SamVisionConfig(image_size=tv.img_size, patch_size=16, out_channels=tv.out_channels),
            decoder=SamDecoderConfig(
                hidden=16, layers=2, heads=2, mlp_dim=32, iou_head_depth=2, iou_head_hidden=16,
            ),
            pe_dim=8,
            tinyvit=tv,
        )

    @staticmethod
    def tiny() -> "SamConfig":
        """A tiny ViT-det SAM for tests: 64 px, patch 8, two blocks (the
        second global), windows of 2."""
        return SamConfig(
            vision=SamVisionConfig(
                image_size=64, patch_size=8, width=32, depth=2, heads=2,
                mlp_dim=64, window_size=2, global_attn_indexes=(1,), out_channels=16,
            ),
            decoder=SamDecoderConfig(
                hidden=16, layers=2, heads=2, mlp_dim=32, iou_head_depth=2, iou_head_hidden=16,
            ),
            pe_dim=8,
        )


class LayerNorm2d(Norm):
    """SAM's channel-wise LayerNorm over NHWC maps. It normalizes in the
    input dtype (not f32), then ``x * weight + bias`` promotes, as the JAX
    module does."""

    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        x = (x - mu) / torch.sqrt(var + 1e-6)
        return x * self.weight + self.bias


def _interp_rel_pos(rel_pos: torch.Tensor, size: int) -> torch.Tensor:
    """A (L, dim) relative-position table resampled to 2 * size - 1 rows,
    as ``jax.image.resize(..., "linear")`` does it (half-pixel centres, an
    anti-aliased kernel when it shrinks); unchanged at that length."""
    need = 2 * size - 1
    if rel_pos.shape[0] == need:
        return rel_pos
    return resize_matmul(rel_pos[:, :, None], need, rel_pos.shape[1])[:, :, 0]


def _decomposed_rel_pos_bias(q: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor,
                             hw: Tuple[int, int]) -> torch.Tensor:
    """ViT-det's relative position bias: q (B*, heads, h*w, dim) -> additive
    logits (B*, heads, h*w, h*w), one term per axis."""
    h, w = hw
    rel_h, rel_w = _interp_rel_pos(rel_h, h), _interp_rel_pos(rel_w, w)
    ih = torch.arange(h, device=q.device)
    iw = torch.arange(w, device=q.device)
    rh = rel_h[ih[:, None] - ih[None, :] + (h - 1)]  # (h, h, dim)
    rw = rel_w[iw[:, None] - iw[None, :] + (w - 1)]  # (w, w, dim)
    b, nh, _, dim = q.shape
    qr = q.reshape(b, nh, h, w, dim)
    qh, rh = promoted(qr, rh)
    bias_h = torch.einsum("bnhwd,hkd->bnhwk", qh, rh)  # (b, nh, h, w, h)
    qw, rw = promoted(qr, rw)
    bias_w = torch.einsum("bnhwd,wkd->bnhwk", qw, rw)  # (b, nh, h, w, w)
    bias = bias_h[..., :, None] + bias_w[..., None, :]  # (b, nh, h, w, h, w)
    return bias.reshape(b, nh, h * w, h * w)


class VitDetAttention(nn.Module):
    """Multi-head attention with one fused qkv projection and the
    decomposed relative-position bias. Logits in the input dtype plus the
    bias, softmax in f32, probabilities cast back, as the JAX module (plain
    ``jnp`` there, no kernel)."""

    def __init__(self, dim: int, heads: int, hw: Tuple[int, int], *, device=None):
        super().__init__()
        self.heads = heads
        self.hw = hw
        head_dim = dim // heads
        self.qkv = Dense(dim, 3 * dim, device=device)
        self.proj = Dense(dim, dim, device=device)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * hw[0] - 1, head_dim, device=device))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * hw[1] - 1, head_dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, d = x.shape
        hd = d // self.heads
        q, k, v = (t.reshape(b, l, self.heads, hd).transpose(1, 2) for t in self.qkv(x).chunk(3, dim=-1))
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        bias = _decomposed_rel_pos_bias(q, self.rel_pos_h, self.rel_pos_w, self.hw)
        logits = logits.to(torch.promote_types(logits.dtype, bias.dtype))
        logits += bias  # in place: at 1024 px a global block's (B, 12, 4096, 4096) logits are 0.8 GB a frame
        del bias
        probs = torch.softmax(logits.to(torch.float32), dim=-1).to(x.dtype)
        del logits
        probs, v = promoted(probs, v)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, l, -1)
        return self.proj(out)


def window_partition(x: torch.Tensor, ws: int):
    """(B, H, W, C) -> (B * nh * nw, ws, ws, C) windows of the map padded
    with zeros up to a multiple of ``ws``, and the padded (Hp, Wp)."""
    b, h, w, c = x.shape
    ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(win: torch.Tensor, ws: int, pad_hw: Tuple[int, int], hw: Tuple[int, int]) -> torch.Tensor:
    hp, wp = pad_hw
    b = win.shape[0] // (hp // ws * wp // ws)
    x = win.reshape(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, : hw[0], : hw[1]]


class VitDetBlock(nn.Module):
    """Pre-norm block: windowed (or global) attention, then the exact-erf
    GELU MLP. A windowed block attends over the zero padding unmasked, as
    upstream does (64 -> 70 tokens a side at 1024 px)."""

    def __init__(self, cfg: SamVisionConfig, is_global: bool, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.is_global = is_global
        hw = (cfg.grid, cfg.grid) if is_global else (cfg.window_size, cfg.window_size)
        self.ln1 = LayerNorm(cfg.width, 1e-6, device=device)
        self.attn = VitDetAttention(cfg.width, cfg.heads, hw, device=device)
        self.ln2 = LayerNorm(cfg.width, 1e-6, device=device)
        self.mlp_fc1 = Dense(cfg.width, cfg.mlp_dim, device=device)
        self.mlp_fc2 = Dense(cfg.mlp_dim, cfg.width, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, C)
        b, h, w, _ = x.shape
        y = self.ln1(x)
        if self.is_global:
            y = self.attn(y.reshape(b, h * w, -1)).reshape(b, h, w, -1)
        else:
            ws = self.cfg.window_size
            win, pad_hw = window_partition(y, ws)
            flat = self.attn(win.reshape(win.shape[0], ws * ws, -1))
            y = window_unpartition(flat.reshape(-1, ws, ws, flat.shape[-1]), ws, pad_hw, (h, w))
        x = x + y
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.ln2(x))))


class _Conv(nn.Conv2d):
    """A flax ``nn.Conv`` over NHWC maps: ``weight`` OIHW (from the flax
    kernel HWIO), ``bias`` where flax has one."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(x, self.weight, self.bias, self.stride[0], self.padding[0])


class SamVisionEncoder(nn.Module):
    """sam-vit-base's ViT-det image encoder: (B, S, S, 3) normalized images
    -> (B, grid, grid, out_channels)."""

    def __init__(self, cfg: SamVisionConfig, *, device=None):
        super().__init__()
        self.cfg = c = cfg
        # flax's "SAME" padding adds nothing when the stride equals the kernel
        self.patch_embed = _Conv(3, c.width, c.patch_size, c.patch_size, device=device)
        self.pos_embed = nn.Parameter(torch.zeros(c.grid, c.grid, c.width, device=device))
        for i in range(c.depth):
            self.add_module(f"block{i}", VitDetBlock(c, i in c.global_attn_indexes, device=device))
        self.neck_conv1 = _Conv(c.width, c.out_channels, 1, bias=False, device=device)
        self.neck_ln1 = LayerNorm2d(c.out_channels, device=device)
        self.neck_conv2 = _Conv(c.out_channels, c.out_channels, 3, padding=1, bias=False, device=device)
        self.neck_ln2 = LayerNorm2d(c.out_channels, device=device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        with exact_f32(images.device):
            x = self.patch_embed(images)
            x = x + self.pos_embed[None]
            for i in range(self.cfg.depth):
                x = getattr(self, f"block{i}")(x)
            x = self.neck_ln1(self.neck_conv1(x))
            return self.neck_ln2(self.neck_conv2(x))


class SamPositionalEmbedding(nn.Module):
    def __init__(self, pe_dim: int, *, device=None):
        super().__init__()
        self.gaussian = nn.Parameter(torch.zeros(2, pe_dim, device=device))

    def forward(self, coords01: torch.Tensor) -> torch.Tensor:  # (..., 2) in [0, 1]
        c, g = promoted(2 * coords01 - 1, self.gaussian)
        proj = (2 * math.pi) * torch.matmul(c, g)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class SamPromptEncoder(nn.Module):
    """Box prompts only (the reference only ever prompts with boxes)."""

    def __init__(self, hidden: int, *, device=None):
        super().__init__()
        self.point_embed = nn.Parameter(torch.zeros(4, hidden, device=device))

    def forward(self, pe: SamPositionalEmbedding, boxes01: torch.Tensor) -> torch.Tensor:
        b, nb = boxes01.shape[:2]
        emb = pe(boxes01.reshape(b, nb, 2, 2))  # (B, NB, 2, hidden)
        # corner types: top-left = label 2, bottom-right = label 3
        return emb + self.point_embed[2:4]  # sparse embeddings (B, NB, 2, hidden)


class DecoderAttention(nn.Module):
    def __init__(self, dim: int, heads: int, internal_dim: int, *, device=None):
        super().__init__()
        self.heads = heads
        self.q_proj = Dense(dim, internal_dim, device=device)
        self.k_proj = Dense(dim, internal_dim, device=device)
        self.v_proj = Dense(dim, internal_dim, device=device)
        self.out_proj = Dense(internal_dim, dim, device=device)

    def _split(self, t: torch.Tensor) -> torch.Tensor:
        return t.reshape(*t.shape[:-1], self.heads, t.shape[-1] // self.heads).transpose(-3, -2)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        hq, hk = promoted(self._split(self.q_proj(q)), self._split(self.k_proj(k)))
        a = torch.matmul(hq, hk.transpose(-1, -2)) * (hq.shape[-1] ** -0.5)
        p, hv = promoted(torch.softmax(a.to(torch.float32), dim=-1).to(q.dtype), self._split(self.v_proj(v)))
        o = torch.matmul(p, hv).transpose(-3, -2)
        return self.out_proj(o.reshape(*o.shape[:-2], -1))


class TwoWayBlock(nn.Module):
    def __init__(self, cfg: SamDecoderConfig, skip_first_layer_pe: bool, *, device=None):
        super().__init__()
        d, dd = cfg.hidden, cfg.hidden // cfg.downsample_rate
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DecoderAttention(d, cfg.heads, d, device=device)
        self.ln1 = LayerNorm(d, 1e-6, device=device)
        self.cross_t2i = DecoderAttention(d, cfg.heads, dd, device=device)
        self.ln2 = LayerNorm(d, 1e-6, device=device)
        self.mlp_lin1 = Dense(d, cfg.mlp_dim, device=device)
        self.mlp_lin2 = Dense(cfg.mlp_dim, d, device=device)
        self.ln3 = LayerNorm(d, 1e-6, device=device)
        self.cross_i2t = DecoderAttention(d, cfg.heads, dd, device=device)
        self.ln4 = LayerNorm(d, 1e-6, device=device)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.ln1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.ln2(queries + self.cross_t2i(q, k, keys))
        queries = self.ln3(queries + self.mlp_lin2(F.relu(self.mlp_lin1(queries))))
        q, k = queries + query_pe, keys + key_pe
        keys = self.ln4(keys + self.cross_i2t(k, q, queries))
        return queries, keys


class Upscale2x(nn.Module):
    """The packed form of ``nn.ConvTranspose(out, (2, 2), strides=(2, 2))``:
    one product that keeps the 2x2 output slots as channel axes, (..., Cin)
    -> (..., 2, 2, out), with no depth-to-space shuffle. Stride equals the
    kernel size, so there is no spatial overlap and a convT -> norm -> gelu
    -> convT chain is pointwise in this layout. ``weight`` is the flax kernel
    (2, 2, Cin, out) laid out as (out, Cin, 2, 2)."""

    def __init__(self, cin: int, out: int, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out, cin, 2, 2, device=device))
        self.bias = nn.Parameter(torch.zeros(out, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # out[2i+p, 2j+q] = sum_c x[i, j, c] * kernel[p, q, c] + bias
        return torch.einsum("...c,dcpq->...pqd", x, self.weight.to(x.dtype)) + self.bias.to(x.dtype)


class SamFeedForward(nn.Module):
    def __init__(self, cin: int, hidden: int, out: int, depth: int, *, device=None):
        super().__init__()
        self.depth = depth
        self.proj_in = Dense(cin, hidden, device=device)
        for i in range(depth - 2):
            self.add_module(f"layer{i}", Dense(hidden, hidden, device=device))
        self.proj_out = Dense(hidden, out, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.proj_in(x))
        for i in range(self.depth - 2):
            x = F.relu(getattr(self, f"layer{i}")(x))
        return self.proj_out(x)


class SamMaskDecoder(nn.Module):
    def __init__(self, cfg: SamDecoderConfig, *, device=None):
        super().__init__()
        self.cfg = c = cfg
        d, m = c.hidden, c.num_multimask_outputs + 1
        self.iou_token = nn.Parameter(torch.zeros(1, d, device=device))
        self.mask_tokens = nn.Parameter(torch.zeros(m, d, device=device))
        for i in range(c.layers):
            self.add_module(f"layer{i}", TwoWayBlock(c, skip_first_layer_pe=(i == 0), device=device))
        self.final_t2i = DecoderAttention(d, c.heads, d // c.downsample_rate, device=device)
        self.ln_final = LayerNorm(d, 1e-6, device=device)
        self.upscale_conv1 = Upscale2x(d, d // 4, device=device)
        self.upscale_ln = LayerNorm2d(d // 4, device=device)
        self.upscale_conv2 = Upscale2x(d // 4, d // 8, device=device)
        for i in range(m):
            self.add_module(f"hyper{i}", SamFeedForward(d, d, d // 8, 3, device=device))
        self.iou_head = SamFeedForward(d, c.iou_head_hidden, m, c.iou_head_depth, device=device)

    def forward(self, image_embed, image_pe, sparse_prompt):
        """image_embed (B, G, G, D); sparse_prompt (B, NB, P, D) -> mask
        logits (B, NB, M, 4G, 4G) and iou scores (B, NB, M)."""
        c = self.cfg
        d, m = c.hidden, c.num_multimask_outputs + 1
        b, g1, g2, _ = image_embed.shape
        nb = sparse_prompt.shape[1]
        out_tokens = torch.cat([self.iou_token, self.mask_tokens], dim=0)  # (M+1, d)
        out_tokens, sparse_prompt = promoted(out_tokens, sparse_prompt)
        tokens = torch.cat([out_tokens.expand(b, nb, m + 1, d), sparse_prompt], dim=2)  # (B, NB, T, d)

        src = image_embed.reshape(b, 1, g1 * g2, d).expand(b, nb, g1 * g2, d)
        pos = image_pe.reshape(1, 1, g1 * g2, d).expand(b, nb, g1 * g2, d)
        q, k = tokens, src
        for i in range(c.layers):
            q, k = getattr(self, f"layer{i}")(q, k, tokens, pos)
        attn = self.final_t2i(q + tokens, k + pos, k)
        q = self.ln_final(q + attn)
        iou_out = q[:, :, 0]
        mask_out = q[:, :, 1:m + 1]  # (B, NB, M, d)

        img = k.reshape(b * nb, g1, g2, d)
        # packed upscale chain: the 2x2 slots ride as channels, so the big
        # per-box tensors are never spatially reshuffled (see Upscale2x)
        up = F.gelu(self.upscale_ln(self.upscale_conv1(img)))  # (B*NB, G, G, 2, 2, d/4)
        up = F.gelu(self.upscale_conv2(up))  # (B*NB, G, G, 2, 2, 2, 2, d/8)
        hyper = torch.stack([getattr(self, f"hyper{i}")(mask_out[:, :, i]) for i in range(m)], dim=2)
        # reduce channels first, then depth-to-space the thin masks:
        # out[4x+2p+r, 4y+2q+s] = packed[x, y, p, q, r, s]
        up = up.reshape(b, nb, g1, g2, 2, 2, 2, 2, d // 8)
        hyper, up = promoted(hyper, up)
        masks = torch.einsum("bnmc,bnxypqrsc->bnmxpryqs", hyper, up).reshape(b, nb, m, 4 * g1, 4 * g2)
        return masks, self.iou_head(iou_out)


SAM_MEAN = (123.675, 116.28, 103.53)
SAM_STD = (58.395, 57.12, 57.375)


class SamModule(nn.Module):
    def __init__(self, cfg: SamConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        if cfg.decoder.hidden != 2 * cfg.pe_dim:
            raise ValueError(f"decoder width {cfg.decoder.hidden} must be 2 * pe_dim ({cfg.pe_dim})")
        if cfg.tinyvit is not None:
            self.vision = TinyViT(cfg.tinyvit, device=device)
        else:
            self.vision = SamVisionEncoder(cfg.vision, device=device)
        self.shared_pe = SamPositionalEmbedding(cfg.pe_dim, device=device)
        self.prompt = SamPromptEncoder(cfg.decoder.hidden, device=device)
        self.decoder = SamMaskDecoder(cfg.decoder, device=device)
        # dense prompt used when no mask input is given (prompt_encoder.no_mask_embed)
        self.no_mask_embed = nn.Parameter(torch.zeros(cfg.decoder.hidden, device=device))

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) raw 0..255 floats -> (B, G, G, out_channels)."""
        with span("vlfm.wait.sam_norm"):
            mean = torch.tensor(SAM_MEAN, dtype=images.dtype, device=images.device)
        with span("vlfm.wait.sam_norm"):
            std = torch.tensor(SAM_STD, dtype=images.dtype, device=images.device)
        return self.vision((images - mean) / std)

    def image_pe(self) -> torch.Tensor:
        g = self.cfg.vision.grid
        ar = torch.arange(g, device=self.no_mask_embed.device)
        rows, cols = torch.meshgrid(ar, ar, indexing="ij")
        # (row, col) -> the PE takes (x, y): flip to (col, row)
        coords = (torch.stack([cols, rows], dim=-1).to(torch.float32) + 0.5) / g
        return self.shared_pe(coords)

    def decode_boxes(self, image_embed: torch.Tensor, boxes01: torch.Tensor):
        # The decoder runs in the embedding's dtype: box coordinates and the
        # f32 positional embedding would otherwise promote every tensor.
        dt = image_embed.dtype
        sparse = self.prompt(self.shared_pe, boxes01).to(dt)
        src = image_embed + self.no_mask_embed.to(dt)
        return self.decoder(src, self.image_pe().to(dt), sparse)

    def forward(self, images, boxes01):
        return self.decode_boxes(self.encode_image(images), boxes01)


# Parameter scales of flax's initializers beyond the module defaults.
_INIT_STDS = {"gaussian": 1.0, "point_embed": 1.0, "iou_token": 1.0, "mask_tokens": 1.0,
              "no_mask_embed": 1.0, "attention_biases": 0.0}


class SAM:
    """Encode once per frame, decode many boxes (inference only)."""

    def __init__(self, cfg: SamConfig, module: SamModule):
        self.cfg = cfg
        self.module = module.eval().requires_grad_(False)

    @classmethod
    def init_random(cls, cfg: SamConfig, seed: int = 0, device: torch.device | str = default_device()) -> "SAM":
        """Random f32 weights on ``device``, drawn from a seeded generator
        there (the same seed gives other numbers than JAX's init)."""
        module = SamModule(cfg, device=device)
        init_random_(module, torch.Generator(device=device).manual_seed(seed), _INIT_STDS)
        return cls(cfg, module)

    @classmethod
    def from_jax_params(cls, cfg: SamConfig, params_np: Mapping[str, Any],
                        device: torch.device | str = default_device()) -> "SAM":
        """Load a ``vlfm_tpu`` SAM parameter tree (either encoder) given as
        numpy arrays. Every parameter must be present and every shape must
        match."""
        module = SamModule(cfg, device=device)
        load_jax_params_(module, params_np)
        return cls(cfg, module)

    @torch.inference_mode()
    def encode(self, images: torch.Tensor) -> torch.Tensor:
        return self.module.encode_image(images)

    @torch.inference_mode()
    def decode(self, image_embed: torch.Tensor, boxes01: torch.Tensor, multimask_output: bool = False):
        """-> (bool masks (B, NB, 4G, 4G), iou (B, NB, M)): one mask per box.
        Without ``multimask_output`` it is mask token 0, as the reference
        asks (SamPredictor.predict(multimask_output=False)); with it, the
        token of the best iou among tokens 1..M-1."""
        masks, iou = self.module.decode_boxes(image_embed, boxes01)
        if multimask_output:
            best = torch.argmax(iou[..., 1:], dim=-1) + 1
            sel = torch.take_along_dim(masks, best[..., None, None, None], dim=2)[:, :, 0]
        else:
            sel = masks[:, :, 0]
        return sel > 0.0, iou

    def segment_boxes(self, images: torch.Tensor, boxes01: torch.Tensor, multimask_output: bool = False):
        """(B, S, S, 3) 0..255 floats + (B, NB, 4) boxes in [0, 1] -> bool
        masks (B, NB, 4G, 4G) at a quarter of the input resolution, and the
        iou scores. One pass: a ``vlfm.sam`` span with its ``frames``, and
        one more on the counters ``sam.passes`` and B on ``sam.frames``."""
        frames = images.shape[0]
        count("sam.passes")
        count("sam.frames", frames)
        with span("vlfm.sam", frames=frames):
            return self.decode(self.encode(images), boxes01, multimask_output)

    @torch.inference_mode()
    def segment_boxes_gated(self, images: torch.Tensor, boxes01: torch.Tensor, frame_valid: torch.Tensor,
                            capacity: int, multimask_output: bool = False):
        """``segment_boxes`` on the frames that hold a valid detection only.

        Frames with one or more valid boxes sort first (a stable sort), then
        ``ceil(n_detection_frames / capacity)`` passes each segment a
        ``capacity``-frame window of that order. The last window is clamped
        to ``[0, B - capacity]``, as ``jax.lax.dynamic_slice_in_dim`` clamps
        it, so frames it takes again get the same masks written again. No
        detection is dropped. The number of passes needs one host read of
        the detection-frame count per call (a ``vlfm.wait.sam_gate`` span);
        the count is added to the counter ``sam.detection_frames``.

        ``frame_valid``: (B, NB) bool. Returns (masks (B, NB, 4G, 4G) bool,
        frame_valid). Frames without detections that share a pass window may
        get masks; ``valid`` gates them downstream.
        """
        b, nb = frame_valid.shape
        if not 1 <= capacity <= b:
            raise ValueError(f"capacity must be in [1, {b}], got {capacity}")
        has = frame_valid.any(dim=1)
        order = torch.argsort((~has).to(torch.uint8), stable=True)  # detection frames first
        with span("vlfm.wait.sam_gate"):
            n_has = int(has.sum())
        count("sam.detection_frames", n_has)
        g4 = 4 * self.cfg.vision.grid
        masks = torch.zeros((b, nb, g4, g4), dtype=torch.bool, device=frame_valid.device)
        kw = {"multimask_output": True} if multimask_output else {}  # the two-argument call by default
        for p in range(-(-n_has // capacity)):
            start = min(p * capacity, b - capacity)
            sel = order[start:start + capacity]
            masks[sel] = self.segment_boxes(images[sel], boxes01[sel], **kw)[0]
        return masks, frame_valid


# ---------------------------------------------------------------------------
# Checkpoint conversion: mobile_sam.pt (segment-anything naming) and HF
# facebook/sam-vit-*
# ---------------------------------------------------------------------------
_CONV_T = (2, 3, 0, 1)  # torch ConvTranspose2d (in, out, kh, kw) -> flax (kh, kw, in, out)


def _dec_attn(sd, name):
    return {p: dense(sd, f"{name}.{p}") for p in ("q_proj", "k_proj", "v_proj", "out_proj")}


def _two_way_layer(sd, p, norms):
    """A mask-decoder transformer layer; ``norms`` names its four norms."""
    return {
        "self_attn": _dec_attn(sd, f"{p}.self_attn"),
        "ln1": norm(sd, f"{p}.{norms[0]}"),
        "cross_t2i": _dec_attn(sd, f"{p}.cross_attn_token_to_image"),
        "ln2": norm(sd, f"{p}.{norms[1]}"),
        "mlp_lin1": dense(sd, f"{p}.mlp.lin1"),
        "mlp_lin2": dense(sd, f"{p}.mlp.lin2"),
        "ln3": norm(sd, f"{p}.{norms[2]}"),
        "cross_i2t": _dec_attn(sd, f"{p}.cross_attn_image_to_token"),
        "ln4": norm(sd, f"{p}.{norms[3]}"),
    }


def _prompt_tree(sd, point_embed: str, gaussian: str) -> Dict[str, Any]:
    return {
        "prompt": {"point_embed": leaf(np.concatenate([sd[f"{point_embed}.{i}.weight"] for i in range(4)], axis=0))},
        "no_mask_embed": leaf(sd["prompt_encoder.no_mask_embed.weight"][0]),
        "shared_pe": {"gaussian": leaf(sd[gaussian])},
    }


def convert_mobile_sam(sd: Mapping[str, Any], cfg: SamConfig) -> Dict[str, Any]:
    """A mobile_sam.pt state dict (the original segment-anything naming, not
    HF's) -> JAX's SAM tree: the TinyViT encoder, the prompt encoder and the
    mask decoder. The decoder's MLPs are ``layers.0..depth-1`` there and
    ``proj_in``, ``layer{i}``, ``proj_out`` here."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    assert cfg.tinyvit is not None, "mobile_sam checkpoints carry a TinyViT encoder"
    vis = convert_mobile_sam_encoder({k: v for k, v in sd.items() if k.startswith("image_encoder.")}, cfg.tinyvit)

    def ff(name, depth):
        out = {"proj_in": dense(sd, f"{name}.layers.0"), "proj_out": dense(sd, f"{name}.layers.{depth - 1}")}
        for j in range(depth - 2):
            out[f"layer{j}"] = dense(sd, f"{name}.layers.{j + 1}")
        return out

    md = "mask_decoder"
    dec: Dict[str, Any] = {
        "iou_token": leaf(sd[f"{md}.iou_token.weight"]),
        "mask_tokens": leaf(sd[f"{md}.mask_tokens.weight"]),
        "final_t2i": _dec_attn(sd, f"{md}.transformer.final_attn_token_to_image"),
        "ln_final": norm(sd, f"{md}.transformer.norm_final_attn"),
        "upscale_conv1": conv(sd, f"{md}.output_upscaling.0", bias=True, axes=_CONV_T),
        "upscale_ln": norm(sd, f"{md}.output_upscaling.1"),
        "upscale_conv2": conv(sd, f"{md}.output_upscaling.3", bias=True, axes=_CONV_T),
        "iou_head": ff(f"{md}.iou_prediction_head", cfg.decoder.iou_head_depth),
    }
    for i in range(cfg.decoder.num_multimask_outputs + 1):
        dec[f"hyper{i}"] = ff(f"{md}.output_hypernetworks_mlps.{i}", 3)
    for i in range(cfg.decoder.layers):
        dec[f"layer{i}"] = _two_way_layer(sd, f"{md}.transformer.layers.{i}", ("norm1", "norm2", "norm3", "norm4"))
    return {"vision": vis, "decoder": dec,
            **_prompt_tree(sd, "prompt_encoder.point_embeddings",
                           "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix")}


def convert_hf_sam(sd: Mapping[str, Any], cfg: SamConfig) -> Dict[str, Any]:
    """A HF SamModel state dict (facebook/sam-vit-*) -> JAX's ViT-det SAM tree."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    ve = "vision_encoder"
    vis: Dict[str, Any] = {
        "patch_embed": conv(sd, f"{ve}.patch_embed.projection"),
        "pos_embed": leaf(sd[f"{ve}.pos_embed"][0]),
        "neck_conv1": conv(sd, f"{ve}.neck.conv1", bias=False),
        "neck_ln1": norm(sd, f"{ve}.neck.layer_norm1"),
        "neck_conv2": conv(sd, f"{ve}.neck.conv2", bias=False),
        "neck_ln2": norm(sd, f"{ve}.neck.layer_norm2"),
    }
    for i in range(cfg.vision.depth):
        p = f"{ve}.layers.{i}"
        vis[f"block{i}"] = {
            "ln1": norm(sd, f"{p}.layer_norm1"),
            "ln2": norm(sd, f"{p}.layer_norm2"),
            "attn": {
                "qkv": dense(sd, f"{p}.attn.qkv"),
                "proj": dense(sd, f"{p}.attn.proj"),
                "rel_pos_h": leaf(sd[f"{p}.attn.rel_pos_h"]),
                "rel_pos_w": leaf(sd[f"{p}.attn.rel_pos_w"]),
            },
            "mlp_fc1": dense(sd, f"{p}.mlp.lin1"),
            "mlp_fc2": dense(sd, f"{p}.mlp.lin2"),
        }
    md = "mask_decoder"
    dec: Dict[str, Any] = {
        "iou_token": leaf(sd[f"{md}.iou_token.weight"]),
        "mask_tokens": leaf(sd[f"{md}.mask_tokens.weight"]),
        "final_t2i": _dec_attn(sd, f"{md}.transformer.final_attn_token_to_image"),
        "ln_final": norm(sd, f"{md}.transformer.layer_norm_final_attn"),
        "upscale_conv1": conv(sd, f"{md}.upscale_conv1", bias=True, axes=_CONV_T),
        "upscale_ln": norm(sd, f"{md}.upscale_layer_norm"),
        "upscale_conv2": conv(sd, f"{md}.upscale_conv2", bias=True, axes=_CONV_T),
        "iou_head": {"proj_in": dense(sd, f"{md}.iou_prediction_head.proj_in"),
                     "proj_out": dense(sd, f"{md}.iou_prediction_head.proj_out")},
    }
    for j in range(cfg.decoder.iou_head_depth - 2):
        dec["iou_head"][f"layer{j}"] = dense(sd, f"{md}.iou_prediction_head.layers.{j}")
    for i in range(cfg.decoder.num_multimask_outputs + 1):
        h = f"{md}.output_hypernetworks_mlps.{i}"
        dec[f"hyper{i}"] = {"proj_in": dense(sd, f"{h}.proj_in"), "proj_out": dense(sd, f"{h}.proj_out"),
                            "layer0": dense(sd, f"{h}.layers.0")}
    for i in range(cfg.decoder.layers):
        dec[f"layer{i}"] = _two_way_layer(sd, f"{md}.transformer.layers.{i}",
                                          ("layer_norm1", "layer_norm2", "layer_norm3", "layer_norm4"))
    return {"vision": vis, "decoder": dec,
            **_prompt_tree(sd, "prompt_encoder.point_embed", "shared_image_embedding.positional_embedding")}


def expected_mobile_sam_checkpoint_keys(cfg: SamConfig) -> Dict[str, Tuple[int, ...]]:
    """Key -> shape table of a whole mobile_sam.pt as ``convert_mobile_sam``
    reads it: ``expected_mobile_sam_keys`` under ``image_encoder.``, then
    the mask decoder and the prompt encoder."""
    assert cfg.tinyvit is not None, "mobile_sam checkpoints carry a TinyViT encoder"
    keys = {f"image_encoder.{k}": s for k, s in expected_mobile_sam_keys(cfg.tinyvit).items()}
    dc = cfg.decoder
    d, dd, m, md = dc.hidden, dc.hidden // dc.downsample_rate, dc.num_multimask_outputs + 1, "mask_decoder"

    def pair(name, shape):
        keys[f"{name}.weight"], keys[f"{name}.bias"] = shape, shape[:1]

    def attn(name, internal):
        for p in ("q_proj", "k_proj", "v_proj"):
            pair(f"{name}.{p}", (internal, d))
        pair(f"{name}.out_proj", (d, internal))

    keys[f"{md}.iou_token.weight"] = (1, d)
    keys[f"{md}.mask_tokens.weight"] = (m, d)
    for i in range(dc.layers):
        p = f"{md}.transformer.layers.{i}"
        attn(f"{p}.self_attn", d)
        attn(f"{p}.cross_attn_token_to_image", dd)
        attn(f"{p}.cross_attn_image_to_token", dd)
        for j in range(1, 5):
            pair(f"{p}.norm{j}", (d,))
        pair(f"{p}.mlp.lin1", (dc.mlp_dim, d))
        pair(f"{p}.mlp.lin2", (d, dc.mlp_dim))
    attn(f"{md}.transformer.final_attn_token_to_image", dd)
    pair(f"{md}.transformer.norm_final_attn", (d,))
    keys[f"{md}.output_upscaling.0.weight"], keys[f"{md}.output_upscaling.0.bias"] = (d, d // 4, 2, 2), (d // 4,)
    pair(f"{md}.output_upscaling.1", (d // 4,))
    keys[f"{md}.output_upscaling.3.weight"], keys[f"{md}.output_upscaling.3.bias"] = (d // 4, d // 8, 2, 2), (d // 8,)
    for i in range(m):
        p = f"{md}.output_hypernetworks_mlps.{i}"
        pair(f"{p}.layers.0", (d, d))
        pair(f"{p}.layers.1", (d, d))
        pair(f"{p}.layers.2", (d // 8, d))
    widths = [d] + [dc.iou_head_hidden] * (dc.iou_head_depth - 1) + [m]
    for j in range(dc.iou_head_depth):
        pair(f"{md}.iou_prediction_head.layers.{j}", (widths[j + 1], widths[j]))
    for i in range(4):
        keys[f"prompt_encoder.point_embeddings.{i}.weight"] = (1, d)
    keys["prompt_encoder.no_mask_embed.weight"] = (1, d)
    keys["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = (2, cfg.pe_dim)
    return keys
