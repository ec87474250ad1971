"""GroundingDINO: open-vocabulary detection with a text-conditioned DETR.

Counterpart of ``vlfm_tpu/models/grounding_dino.py``: the reference's
open-vocabulary detector (vlfm/vlm/grounding_dino.py, SwinT-OGC) in the
huggingface ``GroundingDinoForObjectDetection`` layout of the JAX module.

- A Swin-T backbone (``models/swin.py``), 1x1 and 3x3 conv input
  projections with GroupNorm(32) to d_model, sine position and level
  embeddings;
- a BERT text backbone with the phrase-block self-attention mask built from
  the special tokens ([CLS], [SEP], '.', '?'), and a text projection;
- the feature enhancer: per layer, bi-directional vision<->text fusion with
  layer scale, a text self-attention enhancer, and multi-scale deformable
  self-attention over the flattened pyramid;
- language-guided query selection: per-pixel contrastive class scores and
  proposal boxes, the top ``num_queries`` as decoder queries;
- the decoder: per layer, query self-attention, text cross-attention and
  deformable cross-attention, with iterative box refinement and
  contrastive classification against the text tokens.

The deformable attention's gather is K4 (``ops/deform_gather.py``): the
CUDA kernel on CUDA tensors, one launch per deformable attention (all levels
at once), so ``encoder_layers + decoder_layers`` launches per forward; its
plain version on CPU tensors. Everything else is plain PyTorch, as it is
plain XLA in the JAX package: every LayerNorm is the flax-style
``layers.LayerNorm`` (K1 does not run here), GELU is the exact erf form, and
the decoder's FFN and the text enhancer use ReLU.

Dtypes follow the JAX module op for op, with flax's promotion: a ``Dense``
computes in the promoted type of its input and weight, and a norm with f32
parameters returns f32. Under ``cast_for_serving`` (bf16 weights, f32 norm
scales) the GroupNorms and LayerNorms therefore lift the streams to f32 and
the model computes in f32 with bf16-rounded weights, as the JAX module does.
The deformable attention's output enters ``output_proj`` in f32, as on the
JAX default path.

The caption is encoded once, at batch 1, and reaches the fusion and decoder
layers expanded to the image batch as a broadcast view: the result equals
the JAX module's with the ids and mask tiled to the batch (the
bi-directional attention's global max is over the whole batch, as in JAX and
HF). Query selection takes the top scores by a stable descending sort, so
ties keep index order as ``jax.lax.top_k`` does.

Inference only: no dropout or drop-path, full pixel masks (square resized
images, HF with ``pixel_mask=None``). A HF GroundingDinoForObjectDetection
state dict converts to JAX's tree through ``convert_hf_grounding_dino``
(below), which ``GroundingDinoDetector.from_jax_params`` loads.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vlfm_tpu_torch.device import default_device
from vlfm_tpu_torch.models.hf_convert import conv, dense, leaf, norm
from vlfm_tpu_torch.models.layers import Dense, GroupNorm, LayerNorm, merge_heads, promoted, split_heads
from vlfm_tpu_torch.models.params import init_random_, load_jax_params_
from vlfm_tpu_torch.models.swin import SwinBackbone, SwinConfig, convert_hf_swin
from vlfm_tpu_torch.models.tinyvit import conv_nhwc
from vlfm_tpu_torch.ops.deform_gather import deform_gather
from vlfm_tpu_torch.ops.resize import resize_bilinear

# BERT tokenizer ids for [CLS], [SEP], '.', '?'
SPECIAL_TOKEN_IDS = (101, 102, 1012, 1029)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
F32_MIN = torch.finfo(torch.float32).min


@dataclass(frozen=True)
class BertConfig:
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    vocab_size: int = 30522
    max_position: int = 512
    type_vocab: int = 2
    eps: float = 1e-12


@dataclass(frozen=True)
class GroundingDinoConfig:
    d_model: int = 256
    encoder_layers: int = 6
    decoder_layers: int = 6
    encoder_heads: int = 8
    decoder_heads: int = 8
    encoder_ffn: int = 2048
    decoder_ffn: int = 2048
    num_queries: int = 900
    num_feature_levels: int = 4
    encoder_n_points: int = 4
    decoder_n_points: int = 4
    max_text_len: int = 256
    pe_temperature: float = 20.0
    eps: float = 1e-5
    swin: SwinConfig = field(default_factory=SwinConfig)
    text: BertConfig = field(default_factory=BertConfig)
    # which Swin stages feed the neck (HF GroundingDINO uses stages 2, 3, 4)
    swin_out_stages: Tuple[int, ...] = (1, 2, 3)

    @staticmethod
    def tiny_test() -> "GroundingDinoConfig":
        return GroundingDinoConfig(
            d_model=32, encoder_layers=2, decoder_layers=2, encoder_heads=2,
            decoder_heads=2, encoder_ffn=64, decoder_ffn=64, num_queries=10,
            num_feature_levels=2, encoder_n_points=2, decoder_n_points=2,
            max_text_len=16,
            swin=SwinConfig(embed_dim=16, depths=(2, 2), heads=(2, 4), window=4),
            text=BertConfig(hidden=32, layers=2, heads=2, intermediate=64,
                            vocab_size=2000, max_position=64),
            swin_out_stages=(0, 1),
        )


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted type of both, as ``jnp.einsum``."""
    return torch.matmul(*promoted(a, b))


def _on_host(x, dtype) -> np.ndarray:
    """A host array of ``x`` (a tensor on any device, or array-like)."""
    return np.asarray(x.cpu() if torch.is_tensor(x) else x, dtype)


# ---------------------------------------------------------------------------
# positional embeddings
# ---------------------------------------------------------------------------
def _interleave_sin_cos(t: torch.Tensor) -> torch.Tensor:
    """(..., n) -> (..., n): sin of the even features, cos of the odd ones,
    interleaved (HF's stack-and-flatten)."""
    return torch.stack([torch.sin(t[..., 0::2]), torch.cos(t[..., 1::2])], dim=-1).flatten(-2)


def sine_position_2d(h: int, w: int, d_model: int, temperature: float, device=None) -> torch.Tensor:
    """(h, w, d_model) sine PE, HF GroundingDinoSinePositionEmbedding with a
    full pixel mask (cumsum of ones)."""
    half = d_model // 2
    scale = 2 * math.pi
    y = (torch.arange(1, h + 1, dtype=torch.float32, device=device) / (h + 1e-6) * scale)[:, None]
    x = (torch.arange(1, w + 1, dtype=torch.float32, device=device) / (w + 1e-6) * scale)[None, :]
    dim_t = temperature ** (2 * (torch.arange(half, device=device) // 2) / half)
    px = _interleave_sin_cos(x[..., None] / dim_t).expand(h, w, half)
    py = _interleave_sin_cos(y[..., None] / dim_t).expand(h, w, half)
    return torch.cat([py, px], dim=-1)


def get_sine_pos_embed(pos: torch.Tensor, num_pos_feats: int, exchange_xy: bool = True) -> torch.Tensor:
    """HF get_sine_pos_embed: (..., n) -> (..., n * num_pos_feats)."""
    scale = 2 * math.pi
    dim_t = 10000 ** (2 * (torch.arange(num_pos_feats, device=pos.device) // 2) / num_pos_feats)
    parts = [_interleave_sin_cos(pos[..., i:i + 1] * scale / dim_t) for i in range(pos.shape[-1])]
    if exchange_xy and len(parts) >= 2:
        parts[0], parts[1] = parts[1], parts[0]
    return torch.cat(parts, dim=-1)


# ---------------------------------------------------------------------------
# captions (host side, like the reference's caption handling)
# ---------------------------------------------------------------------------
def text_phrase_masks(input_ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(B, L) ids -> ((B, L, L) bool self-attention mask, (B, L) position ids).

    Tokens between consecutive special tokens attend within their phrase
    block (inclusive of the closing special token); position ids restart
    per phrase (generate_masks_with_special_tokens_and_transfer_map).
    """
    input_ids = np.asarray(input_ids)
    b, l = input_ids.shape
    special = np.isin(input_ids, SPECIAL_TOKEN_IDS)
    mask = np.tile(np.eye(l, dtype=bool)[None], (b, 1, 1))
    pos = np.zeros((b, l), np.int64)
    for row in range(b):
        prev = 0
        for col in np.nonzero(special[row])[0]:
            if col == 0 or col == l - 1:
                mask[row, col, col] = True
                pos[row, col] = 0
            else:
                mask[row, prev + 1:col + 1, prev + 1:col + 1] = True
                pos[row, prev + 1:col + 1] = np.arange(0, col - prev)
            prev = col
    return mask, pos


def build_caption_ids(class_token_ids: List[np.ndarray], max_len: int):
    """Join per-class token id sequences into one GroundingDINO caption:
    [CLS] c1 . c2 . ... [SEP] (the reference's " . "-joined caption,
    grounding_dino.py:70-73). Returns (ids (1, L), mask (1, L), spans) where
    spans[c] = (start, end) token range of class c."""
    ids = [101]
    spans = []
    for toks in class_token_ids:
        start = len(ids)
        ids.extend(int(t) for t in toks)
        spans.append((start, len(ids)))
        ids.append(1012)  # '.'
    ids.append(102)
    ids = ids[:max_len]
    out = np.zeros((1, max_len), np.int64)
    out[0, :len(ids)] = ids
    mask = np.zeros((1, max_len), bool)
    mask[0, :len(ids)] = True
    return out, mask, spans


# ---------------------------------------------------------------------------
# BERT text backbone
# ---------------------------------------------------------------------------
class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, *, device=None):
        super().__init__()
        self.cfg = c = cfg
        self.q = Dense(c.hidden, c.hidden, device=device)
        self.k = Dense(c.hidden, c.hidden, device=device)
        self.v = Dense(c.hidden, c.hidden, device=device)
        self.attn_out = Dense(c.hidden, c.hidden, device=device)
        self.attn_ln = LayerNorm(c.hidden, c.eps, device=device)
        self.ffn_in = Dense(c.hidden, c.intermediate, device=device)
        self.ffn_out = Dense(c.intermediate, c.hidden, device=device)
        self.ffn_ln = LayerNorm(c.hidden, c.eps, device=device)

    def forward(self, x: torch.Tensor, additive_mask: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        q, k, v = (split_heads(f(x), c.heads) for f in (self.q, self.k, self.v))
        logits = _mm(q, k.transpose(-1, -2)) / math.sqrt(c.hidden // c.heads) + additive_mask
        o = merge_heads(_mm(torch.softmax(logits, dim=-1), v))
        x = self.attn_ln(self.attn_out(o) + x)
        h = self.ffn_out(F.gelu(self.ffn_in(x)))
        return self.ffn_ln(h + x)


class BertBackbone(nn.Module):
    def __init__(self, cfg: BertConfig, *, device=None):
        super().__init__()
        self.cfg = c = cfg
        self.word = nn.Embedding(c.vocab_size, c.hidden, device=device)
        self.position = nn.Embedding(c.max_position, c.hidden, device=device)
        self.token_type = nn.Embedding(c.type_vocab, c.hidden, device=device)
        self.embed_ln = LayerNorm(c.hidden, c.eps, device=device)
        for i in range(c.layers):
            self.add_module(f"layer{i}", BertLayer(c, device=device))

    def forward(self, input_ids, self_attn_mask3d, position_ids) -> torch.Tensor:
        x = self.word(input_ids) + self.position(position_ids) + self.token_type(torch.zeros_like(input_ids))
        x = self.embed_ln(x)
        add = torch.where(self_attn_mask3d[:, None], 0.0, -1e9)
        for i in range(self.cfg.layers):
            x = getattr(self, f"layer{i}")(x, add)
        return x


# ---------------------------------------------------------------------------
# deformable attention
# ---------------------------------------------------------------------------
class DeformableAttention(nn.Module):
    def __init__(self, cfg: "GroundingDinoConfig", heads: int, n_points: int, *, device=None):
        super().__init__()
        d, nl = cfg.d_model, cfg.num_feature_levels
        self.heads, self.n_points = heads, n_points
        self.value_proj = Dense(d, d, device=device)
        self.sampling_offsets = Dense(d, heads * nl * n_points * 2, device=device)
        self.attention_weights = Dense(d, heads * nl * n_points, device=device)
        self.output_proj = Dense(d, d, device=device)

    def forward(
        self,
        hidden_states: torch.Tensor,  # (B, Q, D) queries (position already added)
        encoder_hidden_states: torch.Tensor,  # (B, S, D) flattened multi-scale values
        reference_points: torch.Tensor,  # (B, Q, L, 2) or (B, Q, L, 4), normalised
        spatial_shapes: Sequence[Tuple[int, int]],
    ) -> torch.Tensor:
        nh, npts, nl = self.heads, self.n_points, len(spatial_shapes)
        b, q, d = hidden_states.shape
        value = self.value_proj(encoder_hidden_states)
        offsets = self.sampling_offsets(hidden_states).reshape(b, q, nh, nl, npts, 2)
        weights = self.attention_weights(hidden_states).reshape(b, q, nh, nl * npts)
        weights = torch.softmax(weights, dim=-1).reshape(b, q, nh, nl, npts)
        if reference_points.shape[-1] == 2:
            norm = torch.tensor([[wd, ht] for ht, wd in spatial_shapes], dtype=torch.float32,
                                device=hidden_states.device)
            loc = reference_points[:, :, None, :, None, :] + offsets / norm[None, None, None, :, None, :]
        else:
            loc = (
                reference_points[:, :, None, :, None, :2]
                + offsets / npts * reference_points[:, :, None, :, None, 2:] * 0.5
            )
        grids = 2 * loc - 1  # (B, Q, nh, nl, npts, 2), f32
        out = deform_gather(value.contiguous(), spatial_shapes, grids.contiguous(), weights.contiguous())
        return self.output_proj(out.reshape(b, q, d))


# ---------------------------------------------------------------------------
# attention and fusion building blocks
# ---------------------------------------------------------------------------
class MHA(nn.Module):
    """HF GroundingDinoMultiheadAttention (separate q/k/v, scaled dot)."""

    def __init__(self, d_model: int, heads: int, *, device=None):
        super().__init__()
        self.heads = heads
        self.query = Dense(d_model, d_model, device=device)
        self.key = Dense(d_model, d_model, device=device)
        self.value = Dense(d_model, d_model, device=device)
        self.out_proj = Dense(d_model, d_model, device=device)

    def forward(self, queries, keys, values, additive_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        q = split_heads(self.query(queries), self.heads)
        k = split_heads(self.key(keys), self.heads)
        v = split_heads(self.value(values), self.heads)
        logits = _mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        if additive_mask is not None:
            logits = logits + additive_mask
        return self.out_proj(merge_heads(_mm(torch.softmax(logits, dim=-1), v)))


class BiMultiHeadAttention(nn.Module):
    def __init__(self, cfg: "GroundingDinoConfig", *, device=None):
        super().__init__()
        d, embed = cfg.d_model, cfg.encoder_ffn // 2
        self.heads = cfg.encoder_heads // 2
        self.vision_proj = Dense(d, embed, device=device)
        self.text_proj = Dense(d, embed, device=device)
        self.values_vision_proj = Dense(d, embed, device=device)
        self.values_text_proj = Dense(d, embed, device=device)
        self.out_vision_proj = Dense(embed, d, device=device)
        self.out_text_proj = Dense(embed, d, device=device)

    def forward(self, vision, text, text_pad_mask):
        heads = self.heads
        hd = self.vision_proj.out_features // heads
        vq = split_heads(self.vision_proj(vision) * (hd**-0.5), heads)
        tk = split_heads(self.text_proj(text), heads)
        vv = split_heads(self.values_vision_proj(vision), heads)
        tv = split_heads(self.values_text_proj(text), heads)

        attn = _mm(vq, tk.transpose(-1, -2))  # (B, heads, V, T)
        attn = attn - attn.max()  # one max over the whole batch, as HF and JAX
        attn = attn.clamp(-50000, 50000)
        attn_t = attn.transpose(-1, -2)
        attn_t = attn_t - attn_t.amax(dim=-1, keepdim=True)
        attn_t = attn_t.clamp(-50000, 50000)

        text_w = torch.softmax(attn_t, dim=-1)  # text -> vision (no vision padding)
        if text_pad_mask is not None:
            attn = torch.where(text_pad_mask[:, None, None, :], -torch.inf, attn)
        vision_w = torch.softmax(attn, dim=-1)
        v_out = merge_heads(_mm(vision_w, tv))
        t_out = merge_heads(_mm(text_w, vv))
        return self.out_vision_proj(v_out), self.out_text_proj(t_out)


class FusionLayer(nn.Module):
    def __init__(self, cfg: "GroundingDinoConfig", *, device=None):
        super().__init__()
        d = cfg.d_model
        self.ln_vision = LayerNorm(d, cfg.eps, device=device)
        self.ln_text = LayerNorm(d, cfg.eps, device=device)
        self.attn = BiMultiHeadAttention(cfg, device=device)
        self.vision_param = nn.Parameter(torch.full((d,), 1e-4, device=device))
        self.text_param = nn.Parameter(torch.full((d,), 1e-4, device=device))

    def forward(self, vision, text, text_pad_mask):
        v, t = self.ln_vision(vision), self.ln_text(text)
        dv, dt = self.attn(v, t, text_pad_mask)
        return v + self.vision_param * dv, t + self.text_param * dt


class TextEnhancerLayer(nn.Module):
    def __init__(self, cfg: "GroundingDinoConfig", *, device=None):
        super().__init__()
        d = cfg.d_model
        self.self_attn = MHA(d, cfg.encoder_heads // 2, device=device)
        self.ln_before = LayerNorm(d, cfg.eps, device=device)
        self.fc1 = Dense(d, cfg.encoder_ffn // 2, device=device)
        self.fc2 = Dense(cfg.encoder_ffn // 2, d, device=device)
        self.ln_after = LayerNorm(d, cfg.eps, device=device)

    def forward(self, text, phrase_mask3d, text_pos):
        add = torch.where(phrase_mask3d[:, None], 0.0, F32_MIN)
        qk = text + text_pos
        x = self.ln_before(text + self.self_attn(qk, qk, text, add))
        return self.ln_after(x + self.fc2(F.relu(self.fc1(x))))


class DeformableLayer(nn.Module):
    def __init__(self, cfg: "GroundingDinoConfig", *, device=None):
        super().__init__()
        d = cfg.d_model
        self.self_attn = DeformableAttention(cfg, cfg.encoder_heads, cfg.encoder_n_points, device=device)
        self.ln_attn = LayerNorm(d, cfg.eps, device=device)
        self.fc1 = Dense(d, cfg.encoder_ffn, device=device)
        self.fc2 = Dense(cfg.encoder_ffn, d, device=device)
        self.ln_ffn = LayerNorm(d, cfg.eps, device=device)

    def forward(self, vision, vision_pos, reference_points, spatial_shapes):
        a = self.self_attn(vision + vision_pos, vision, reference_points, spatial_shapes)
        x = self.ln_attn(vision + a)
        return self.ln_ffn(x + self.fc2(F.relu(self.fc1(x))))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: "GroundingDinoConfig", *, device=None):
        super().__init__()
        self.fusion = FusionLayer(cfg, device=device)
        self.text_enhancer = TextEnhancerLayer(cfg, device=device)
        self.deformable = DeformableLayer(cfg, device=device)

    def forward(self, vision, text, vision_pos, text_pos, phrase_mask3d, text_pad_mask,
                reference_points, spatial_shapes):
        vision, text = self.fusion(vision, text, text_pad_mask)
        text = self.text_enhancer(text, phrase_mask3d, text_pos)
        vision = self.deformable(vision, vision_pos, reference_points, spatial_shapes)
        return vision, text


class DecoderLayer(nn.Module):
    def __init__(self, cfg: "GroundingDinoConfig", *, device=None):
        super().__init__()
        d = cfg.d_model
        self.self_attn = MHA(d, cfg.decoder_heads, device=device)
        self.ln_self = LayerNorm(d, cfg.eps, device=device)
        self.text_attn = MHA(d, cfg.decoder_heads, device=device)
        self.ln_text = LayerNorm(d, cfg.eps, device=device)
        self.cross_attn = DeformableAttention(cfg, cfg.decoder_heads, cfg.decoder_n_points, device=device)
        self.ln_cross = LayerNorm(d, cfg.eps, device=device)
        self.fc1 = Dense(d, cfg.decoder_ffn, device=device)
        self.fc2 = Dense(cfg.decoder_ffn, d, device=device)
        self.ln_ffn = LayerNorm(d, cfg.eps, device=device)

    def forward(self, x, query_pos, reference_points, vision, text, text_pad_mask, spatial_shapes):
        qk = x + query_pos
        x = self.ln_self(x + self.self_attn(qk, qk, x))
        add = torch.where(text_pad_mask[:, None, None, :], F32_MIN, 0.0)
        x = self.ln_text(x + self.text_attn(x + query_pos, text, text, add))
        x = self.ln_cross(x + self.cross_attn(x + query_pos, vision, reference_points, spatial_shapes))
        return self.ln_ffn(x + self.fc2(F.relu(self.fc1(x))))


class MLPHead(nn.Module):
    def __init__(self, d_in: int, hidden: int, out: int, layers: int, *, device=None):
        super().__init__()
        self.layers = layers
        dims = [d_in] + [hidden] * (layers - 1) + [out]
        for i in range(layers):
            self.add_module(f"layer{i}", Dense(dims[i], dims[i + 1], device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.layers - 1):
            x = F.relu(getattr(self, f"layer{i}")(x))
        return getattr(self, f"layer{self.layers - 1}")(x)


def _inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores along the last axis in the order of
    ``jax.lax.top_k``: descending, ties by index. A stable descending sort
    (``torch.topk`` promises no order among ties, and the invalid proposals
    all tie)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1][..., :k]


def _swin_channels(cfg: "GroundingDinoConfig") -> List[int]:
    return [cfg.swin.embed_dim * 2**i for i in range(len(cfg.swin.depths))]


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------
class GroundingDinoModule(nn.Module):
    def __init__(self, cfg: GroundingDinoConfig, *, device=None):
        super().__init__()
        self.cfg = c = cfg
        d = c.d_model
        self.swin = SwinBackbone(c.swin, c.swin_out_stages, device=device)
        self.bert = BertBackbone(c.text, device=device)
        self.text_projection = Dense(c.text.hidden, d, device=device)
        chans = [_swin_channels(c)[i] for i in c.swin_out_stages]
        for li in range(c.num_feature_levels):
            if li < len(chans):
                conv = nn.Conv2d(chans[li], d, 1, device=device)
            else:
                conv = nn.Conv2d(chans[-1] if li == len(chans) else d, d, 3, 2, 1, device=device)
            self.add_module(f"input_proj{li}_conv", conv)
            self.add_module(f"input_proj{li}_gn", GroupNorm(min(32, d), d, device=device))
        self.level_embed = nn.Parameter(torch.zeros(c.num_feature_levels, d, device=device))
        for i in range(c.encoder_layers):
            self.add_module(f"enc{i}", EncoderLayer(c, device=device))
        self.enc_output = Dense(d, d, device=device)
        self.enc_output_norm = LayerNorm(d, c.eps, device=device)
        self.encoder_output_bbox_embed = MLPHead(d, d, 4, 3, device=device)
        self.query_position_embeddings = nn.Parameter(torch.zeros(c.num_queries, d, device=device))
        self.reference_points_head = MLPHead(2 * d, d, d, 2, device=device)
        self.decoder_ln = LayerNorm(d, c.eps, device=device)
        for i in range(c.decoder_layers):
            self.add_module(f"dec{i}", DecoderLayer(c, device=device))
            self.add_module(f"dec_bbox{i}", MLPHead(d, d, 4, 3, device=device))

    def _neck(self, images: torch.Tensor):
        """Swin pyramid -> projected, GroupNormed maps, with the extra
        stride-2 levels."""
        c = self.cfg
        feats_all = self.swin(images)
        feats = [feats_all[i] for i in c.swin_out_stages]
        maps = []
        for li in range(c.num_feature_levels):
            conv = getattr(self, f"input_proj{li}_conv")
            if li < len(feats):
                y = conv_nhwc(feats[li], conv.weight, conv.bias)
            else:
                src = feats[-1] if li == len(feats) else maps[-1]
                y = conv_nhwc(src, conv.weight, conv.bias, stride=2, padding=1)
            maps.append(getattr(self, f"input_proj{li}_gn")(y))
        return maps

    def _contrastive(self, q: torch.Tensor, t: torch.Tensor, text_pad_mask: torch.Tensor) -> torch.Tensor:
        logits = _mm(q, t.transpose(-1, -2))
        logits = torch.where(text_pad_mask[:, None, :], -torch.inf, logits)
        return F.pad(logits, (0, self.cfg.max_text_len - logits.shape[-1]), value=-torch.inf)

    def forward(self, images, input_ids, phrase_mask3d, position_ids, text_pad_mask):
        """images (B, S, S, 3) ImageNet-normalised; ids, masks and position
        ids (1, L) or (B, L). A caption of batch 1 is encoded once and
        broadcast to the image batch.

        Returns (logits (B, Q, max_text_len), boxes (B, Q, 4) cxcywh in [0, 1]).
        """
        c = self.cfg
        b = images.shape[0]
        dev = images.device

        # --- backbones ----------------------------------------------------
        maps = self._neck(images)
        text = self.text_projection(self.bert(input_ids, phrase_mask3d, position_ids))
        text = text.expand(b, -1, -1)

        # --- flatten the pyramid ------------------------------------------
        spatial_shapes = tuple((m.shape[1], m.shape[2]) for m in maps)
        vision = torch.cat([m.reshape(b, -1, c.d_model) for m in maps], dim=1)  # (B, S, D)
        pos = [sine_position_2d(h, w, c.d_model, c.pe_temperature, dev).reshape(1, h * w, c.d_model)
               + self.level_embed[li] for li, (h, w) in enumerate(spatial_shapes)]
        vision_pos = torch.cat(pos, dim=1).expand(vision.shape)

        # --- encoder --------------------------------------------------------
        refs = []
        for h, w in spatial_shapes:
            ry = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
            rx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
            refs.append(torch.stack(torch.meshgrid(rx, ry, indexing="xy"), -1).reshape(-1, 2))
        s = vision.shape[1]
        ref_pts = torch.cat(refs, 0)[None, :, None, :].expand(b, s, c.num_feature_levels, 2)
        text_pos = get_sine_pos_embed(position_ids[..., None].to(torch.float32), c.d_model, exchange_xy=False)
        for i in range(c.encoder_layers):
            vision, text = getattr(self, f"enc{i}")(
                vision, text, vision_pos, text_pos, phrase_mask3d, text_pad_mask, ref_pts, spatial_shapes)

        # --- language-guided query selection (two-stage) --------------------
        proposals = []
        for li, (h, w) in enumerate(spatial_shapes):
            gy = ((torch.arange(h, dtype=torch.float32, device=dev)[:, None] + 0.5) / h).expand(h, w)
            gx = ((torch.arange(w, dtype=torch.float32, device=dev)[None, :] + 0.5) / w).expand(h, w)
            wh = torch.full((h, w, 2), 0.05 * (2.0**li), device=dev)
            proposals.append(torch.cat([torch.stack([gx, gy], -1), wh], -1).reshape(-1, 4))
        proposals = torch.cat(proposals, 0)[None]  # (1, S, 4)
        valid = ((proposals > 0.01) & (proposals < 0.99)).all(-1, keepdim=True)
        prop_logits = torch.where(valid, torch.log(proposals / (1 - proposals)), torch.inf)

        obj = self.enc_output_norm(self.enc_output(torch.where(valid, vision, 0.0)))
        enc_class = self._contrastive(obj, text, text_pad_mask)  # (B, S, max_text_len)
        enc_box_logits = self.encoder_output_bbox_embed(obj) + prop_logits
        topk_idx = top_k_indices(enc_class.amax(-1), c.num_queries)
        ref_boxes = torch.take_along_dim(enc_box_logits, topk_idx[..., None], dim=1)
        reference = torch.sigmoid(ref_boxes)  # (B, Q, 4)

        x = self.query_position_embeddings[None].expand(b, c.num_queries, c.d_model)

        # --- decoder ----------------------------------------------------------
        for i in range(c.decoder_layers):
            ref_input = reference[:, :, None, :].expand(b, c.num_queries, c.num_feature_levels, 4)
            query_pos = self.reference_points_head(get_sine_pos_embed(reference, c.d_model // 2, exchange_xy=True))
            x = getattr(self, f"dec{i}")(x, query_pos, ref_input, vision, text, text_pad_mask, spatial_shapes)
            delta = getattr(self, f"dec_bbox{i}")(x)
            reference = torch.sigmoid(delta + _inverse_sigmoid(reference))

        logits = self._contrastive(self.decoder_ln(x), text, text_pad_mask)
        return logits, reference


def deformable_attentions(cfg: GroundingDinoConfig) -> int:
    """K4 launches per forward: one per deformable attention."""
    return cfg.encoder_layers + cfg.decoder_layers


class GroundingDinoDetector:
    """Detection entry points around a ``GroundingDinoModule`` (inference
    only), in the role of the reference detector's ``predict``."""

    def __init__(self, cfg: GroundingDinoConfig, module: GroundingDinoModule):
        self.cfg = cfg
        self.module = module.eval().requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.module.level_embed.device

    @classmethod
    def init_random(cls, cfg: GroundingDinoConfig, seed: int = 0,
                    device: torch.device | str = default_device()) -> "GroundingDinoDetector":
        """Random f32 weights on ``device``, drawn from a seeded generator
        there with the flax initialisers' scales (the same seed gives other
        numbers than JAX's init); the fusion layers' layer scales are 1e-4."""
        module = GroundingDinoModule(cfg, device=device)
        init_random_(module, torch.Generator(device=device).manual_seed(seed),
                     stds={"level_embed": 1.0, "query_position_embeddings": 1.0})
        with torch.no_grad():
            for name, p in module.named_parameters():
                if name.endswith(("vision_param", "text_param")):
                    p.fill_(1e-4)
        return cls(cfg, module)

    @classmethod
    def from_jax_params(cls, cfg: GroundingDinoConfig, params_np: Mapping[str, Any],
                        device: torch.device | str = default_device()) -> "GroundingDinoDetector":
        """Load a ``vlfm_tpu`` GroundingDINO parameter tree given as numpy
        arrays. Every parameter must be present and every shape must match."""
        module = GroundingDinoModule(cfg, device=device)
        load_jax_params_(module, params_np)
        return cls(cfg, module)

    @torch.inference_mode()
    def predict(self, images: torch.Tensor, input_ids, attention_mask):
        """images ImageNet-normalised NHWC on the detector's device; ids and
        mask (1, L) or (B, L), host arrays or tensors.

        Returns (logits (B, Q, max_text_len), boxes cxcywh (B, Q, 4)).
        """
        ids, am = _on_host(input_ids, np.int64), _on_host(attention_mask, bool)
        m3, pos = text_phrase_masks(ids)
        dev = self.device
        return self.module(
            images,
            torch.from_numpy(ids).to(dev),
            torch.from_numpy(m3).to(dev),
            torch.from_numpy(pos).to(dev),
            torch.from_numpy(~am).to(dev),
        )


# ---------------------------------------------------------------------------
# HF conversion (GroundingDinoForObjectDetection layout)
# ---------------------------------------------------------------------------
def _lin(sd, name):
    return dense(sd, name, bias=None)


def _mha(sd, name):
    return {p: _lin(sd, f"{name}.{p}") for p in ("query", "key", "value", "out_proj")}


def _deform(sd, name):
    return {p: _lin(sd, f"{name}.{p}") for p in ("value_proj", "sampling_offsets", "attention_weights", "output_proj")}


def _mlp_head(sd, name, layers):
    return {f"layer{i}": _lin(sd, f"{name}.layers.{i}") for i in range(layers)}


def convert_hf_grounding_dino(sd: Mapping[str, Any], cfg: GroundingDinoConfig) -> Dict[str, Any]:
    """A HF GroundingDinoForObjectDetection state dict -> JAX's
    GroundingDINO tree (the Swin backbone through ``convert_hf_swin``)."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    sw = "model.backbone.conv_encoder.model."
    p: Dict[str, Any] = {"swin": convert_hf_swin({k[len(sw):]: v for k, v in sd.items() if k.startswith(sw)},
                                                 cfg.swin)}
    tb = "model.text_backbone"
    bert: Dict[str, Any] = {
        "word": {"embedding": leaf(sd[f"{tb}.embeddings.word_embeddings.weight"])},
        "position": {"embedding": leaf(sd[f"{tb}.embeddings.position_embeddings.weight"])},
        "token_type": {"embedding": leaf(sd[f"{tb}.embeddings.token_type_embeddings.weight"])},
        "embed_ln": norm(sd, f"{tb}.embeddings.LayerNorm"),
    }
    for i in range(cfg.text.layers):
        t = f"{tb}.encoder.layer.{i}"
        bert[f"layer{i}"] = {
            "q": _lin(sd, f"{t}.attention.self.query"),
            "k": _lin(sd, f"{t}.attention.self.key"),
            "v": _lin(sd, f"{t}.attention.self.value"),
            "attn_out": _lin(sd, f"{t}.attention.output.dense"),
            "attn_ln": norm(sd, f"{t}.attention.output.LayerNorm"),
            "ffn_in": _lin(sd, f"{t}.intermediate.dense"),
            "ffn_out": _lin(sd, f"{t}.output.dense"),
            "ffn_ln": norm(sd, f"{t}.output.LayerNorm"),
        }
    p["bert"] = bert
    p["text_projection"] = _lin(sd, "model.text_projection")
    for li in range(cfg.num_feature_levels):
        p[f"input_proj{li}_conv"] = conv(sd, f"model.input_proj_vision.{li}.0")
        p[f"input_proj{li}_gn"] = norm(sd, f"model.input_proj_vision.{li}.1")
    p["level_embed"] = leaf(sd["model.level_embed"])
    for i in range(cfg.encoder_layers):
        e = f"model.encoder.layers.{i}"
        fa, te, dl = f"{e}.fusion_layer.attn", f"{e}.text_enhancer_layer", f"{e}.deformable_layer"
        p[f"enc{i}"] = {
            "fusion": {
                "ln_vision": norm(sd, f"{e}.fusion_layer.layer_norm_vision"),
                "ln_text": norm(sd, f"{e}.fusion_layer.layer_norm_text"),
                "vision_param": leaf(sd[f"{e}.fusion_layer.vision_param"]),
                "text_param": leaf(sd[f"{e}.fusion_layer.text_param"]),
                "attn": {q: _lin(sd, f"{fa}.{q}") for q in (
                    "vision_proj", "text_proj", "values_vision_proj", "values_text_proj",
                    "out_vision_proj", "out_text_proj")},
            },
            "text_enhancer": {
                "self_attn": _mha(sd, f"{te}.self_attn"),
                "ln_before": norm(sd, f"{te}.layer_norm_before"),
                "ln_after": norm(sd, f"{te}.layer_norm_after"),
                "fc1": _lin(sd, f"{te}.fc1"),
                "fc2": _lin(sd, f"{te}.fc2"),
            },
            "deformable": {
                "self_attn": _deform(sd, f"{dl}.self_attn"),
                "ln_attn": norm(sd, f"{dl}.self_attn_layer_norm"),
                "fc1": _lin(sd, f"{dl}.fc1"),
                "fc2": _lin(sd, f"{dl}.fc2"),
                "ln_ffn": norm(sd, f"{dl}.final_layer_norm"),
            },
        }
    p["enc_output"] = _lin(sd, "model.enc_output")
    p["enc_output_norm"] = norm(sd, "model.enc_output_norm")
    p["encoder_output_bbox_embed"] = _mlp_head(sd, "model.encoder_output_bbox_embed", 3)
    p["query_position_embeddings"] = leaf(sd["model.query_position_embeddings.weight"])
    p["reference_points_head"] = _mlp_head(sd, "model.decoder.reference_points_head", 2)
    p["decoder_ln"] = norm(sd, "model.decoder.layer_norm")
    for i in range(cfg.decoder_layers):
        dl = f"model.decoder.layers.{i}"
        p[f"dec{i}"] = {
            "self_attn": _mha(sd, f"{dl}.self_attn"),
            "ln_self": norm(sd, f"{dl}.self_attn_layer_norm"),
            "text_attn": _mha(sd, f"{dl}.encoder_attn_text"),
            "ln_text": norm(sd, f"{dl}.encoder_attn_text_layer_norm"),
            "cross_attn": _deform(sd, f"{dl}.encoder_attn"),
            "ln_cross": norm(sd, f"{dl}.encoder_attn_layer_norm"),
            "fc1": _lin(sd, f"{dl}.fc1"),
            "fc2": _lin(sd, f"{dl}.fc2"),
            "ln_ffn": norm(sd, f"{dl}.final_layer_norm"),
        }
        p[f"dec_bbox{i}"] = _mlp_head(sd, f"model.decoder.bbox_embed.{i}", 3)
    return p


# ---------------------------------------------------------------------------
# detection-pipeline adapter
# ---------------------------------------------------------------------------
class GroundingDinoQueryAdapter:
    """Plugs GroundingDINO into ``DetectionPipeline`` with the OWL-ViT
    detector's surface (``device``, ``preprocess``, ``detect``): the class
    names become one joint caption, and a class's logit is the max over its
    token span (the reference's exact-phrase filtering).

    The spans are kept per caption (keyed by its ids), not as one mutable
    field: the pipeline caches ids per target, so a call for a cached
    target reads its own caption's spans whatever was encoded since.
    """

    def __init__(self, detector: GroundingDinoDetector, image_size: int = 800):
        self.detector = detector
        self.image_size = image_size
        self._spans: Dict[Tuple[int, ...], List[Tuple[int, int]]] = {}

    @property
    def device(self) -> torch.device:
        return self.detector.device

    @staticmethod
    def _key(ids: np.ndarray) -> Tuple[int, ...]:
        return tuple(np.asarray(ids, np.int64).reshape(-1).tolist())

    def make_query_encoder(self, tokenize_class):
        """Returns an ``encode_queries`` callable for ``DetectionPipeline``.
        ``tokenize_class(name) -> token id array`` (WordPiece, no specials)."""

        def encode(names):
            toks = [np.asarray(tokenize_class(n)) for n in names]
            ids, mask, spans = build_caption_ids(toks, self.detector.cfg.max_text_len)
            self._spans[self._key(ids)] = spans
            return ids, mask

        return encode

    def preprocess(self, rgb_uint8: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 -> ImageNet-normalised f32 at the model size."""
        s = self.image_size
        x = resize_bilinear(rgb_uint8.to(torch.float32) / 255.0, s, s)
        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
        std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
        return (x - mean) / std

    def detect(self, images: torch.Tensor, input_ids, attention_mask):
        """-> (boxes cxcywh (B, Q, 4), per-class logits (B, Q, C))."""
        ids = _on_host(input_ids, np.int64)
        spans = self._spans[self._key(ids)]
        logits, boxes = self.detector.predict(images, ids, attention_mask)
        return boxes, torch.stack([logits[..., s:e].amax(-1) for s, e in spans], dim=-1)
