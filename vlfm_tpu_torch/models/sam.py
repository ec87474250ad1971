"""Promptable segmentation (MobileSAM) as batched GPU inference.

Counterpart of ``vlfm_tpu/models/sam.py`` with its TinyViT encoder
(reference: the MobileSAM server, vlfm/vlm/sam.py:24-57, one
``segment_bbox(image, xyxy)`` call per box). The image is encoded once per
frame and all boxes of all frames decode in one batched call; gated
segmentation runs only the frames that hold a detection, in passes of a
fixed frame capacity.

Submodules carry the flax scope names (``vision``, ``shared_pe``,
``prompt``, ``decoder.layer0.cross_t2i``, ...), so ``SAM.from_jax_params``
loads a JAX tree through ``params.state_dict_from_jax_params``. Only the
TinyViT encoder is ported; the ViT-det encoder of the JAX module is not
(ROADMAP Queue 1).

Precision mirrors flax's promotion: the decoder runs in the embedding's
dtype, and a norm with f32 parameters lifts a bf16 stream to f32. With
``cast_for_serving`` the neck's LayerNorm2d keeps an f32 scale, so the
embedding and the decoder are f32 behind a bf16 encoder, as in JAX.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vlfm_tpu_torch.device import default_device
from vlfm_tpu_torch.models.layers import Dense, LayerNorm, Norm
from vlfm_tpu_torch.models.params import init_random_, state_dict_from_jax_params
from vlfm_tpu_torch.models.tinyvit import TinyViT, TinyViTConfig


@dataclass(frozen=True)
class SamVisionConfig:
    image_size: int = 1024
    patch_size: int = 16
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
    tinyvit: TinyViTConfig = field(default_factory=TinyViTConfig)

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


def _promoted(*ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in ts)


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


class SamPositionalEmbedding(nn.Module):
    def __init__(self, pe_dim: int, *, device=None):
        super().__init__()
        self.gaussian = nn.Parameter(torch.zeros(2, pe_dim, device=device))

    def forward(self, coords01: torch.Tensor) -> torch.Tensor:  # (..., 2) in [0, 1]
        c, g = _promoted(2 * coords01 - 1, self.gaussian)
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
        hq, hk = _promoted(self._split(self.q_proj(q)), self._split(self.k_proj(k)))
        a = torch.matmul(hq, hk.transpose(-1, -2)) * (hq.shape[-1] ** -0.5)
        p, hv = _promoted(torch.softmax(a.to(torch.float32), dim=-1).to(q.dtype), self._split(self.v_proj(v)))
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
        out_tokens, sparse_prompt = _promoted(out_tokens, sparse_prompt)
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
        hyper, up = _promoted(hyper, up)
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
        self.vision = TinyViT(cfg.tinyvit, device=device)
        self.shared_pe = SamPositionalEmbedding(cfg.pe_dim, device=device)
        self.prompt = SamPromptEncoder(cfg.decoder.hidden, device=device)
        self.decoder = SamMaskDecoder(cfg.decoder, device=device)
        # dense prompt used when no mask input is given (prompt_encoder.no_mask_embed)
        self.no_mask_embed = nn.Parameter(torch.zeros(cfg.decoder.hidden, device=device))

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) raw 0..255 floats -> (B, G, G, out_channels)."""
        mean = torch.tensor(SAM_MEAN, dtype=images.dtype, device=images.device)
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
        """Load a ``vlfm_tpu`` SAM (TinyViT) parameter tree given as numpy
        arrays. Every parameter must be present and every shape must match."""
        module = SamModule(cfg, device=device)
        module.load_state_dict(state_dict_from_jax_params(params_np), strict=True)
        return cls(cfg, module)

    @torch.inference_mode()
    def encode(self, images: torch.Tensor) -> torch.Tensor:
        return self.module.encode_image(images)

    @torch.inference_mode()
    def decode(self, image_embed: torch.Tensor, boxes01: torch.Tensor):
        """-> (bool masks (B, NB, 4G, 4G) of mask token 0, iou (B, NB, M)):
        one mask per box, as the reference asks
        (SamPredictor.predict(multimask_output=False))."""
        masks, iou = self.module.decode_boxes(image_embed, boxes01)
        return masks[:, :, 0] > 0.0, iou

    def segment_boxes(self, images: torch.Tensor, boxes01: torch.Tensor):
        """(B, S, S, 3) 0..255 floats + (B, NB, 4) boxes in [0, 1] -> bool
        masks (B, NB, 4G, 4G) at a quarter of the input resolution, and the
        iou scores."""
        return self.decode(self.encode(images), boxes01)

    @torch.inference_mode()
    def segment_boxes_gated(self, images: torch.Tensor, boxes01: torch.Tensor, frame_valid: torch.Tensor,
                            capacity: int):
        """``segment_boxes`` on the frames that hold a valid detection only.

        Frames with one or more valid boxes sort first (a stable sort), then
        ``ceil(n_detection_frames / capacity)`` passes each segment a
        ``capacity``-frame window of that order. The last window is clamped
        to ``[0, B - capacity]``, as ``jax.lax.dynamic_slice_in_dim`` clamps
        it, so frames it takes again get the same masks written again. No
        detection is dropped. The number of passes needs one host read of
        the detection-frame count per call.

        ``frame_valid``: (B, NB) bool. Returns (masks (B, NB, 4G, 4G) bool,
        frame_valid). Frames without detections that share a pass window may
        get masks; ``valid`` gates them downstream.
        """
        b, nb = frame_valid.shape
        if not 1 <= capacity <= b:
            raise ValueError(f"capacity must be in [1, {b}], got {capacity}")
        has = frame_valid.any(dim=1)
        order = torch.argsort((~has).to(torch.uint8), stable=True)  # detection frames first
        n_has = int(has.sum())
        g4 = 4 * self.cfg.vision.grid
        masks = torch.zeros((b, nb, g4, g4), dtype=torch.bool, device=frame_valid.device)
        for p in range(-(-n_has // capacity)):
            start = min(p * capacity, b - capacity)
            sel = order[start:start + capacity]
            masks[sel] = self.segment_boxes(images[sel], boxes01[sel])[0]
        return masks, frame_valid
