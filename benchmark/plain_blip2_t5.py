"""A plain reference of BLIP-2 flan-T5 and of VLFM's detection veto, written apart from the port.

What it computes, from the published descriptions:

- **T5 v1.1 / flan-T5** (Raffel et al., JMLR 2020, and the v1.1 notes of
  the T5 repository; ``google/flan-t5-xl``): RMSNorm without a mean and
  without a bias; relative-position buckets, bidirectional in the encoder
  and causal in the decoder (half the buckets exact, the rest logarithmic
  up to ``rel_max_distance``), one (buckets, heads) table owned by layer 0
  of each stack and added to every layer's self-attention logits; no
  1/sqrt(d) logit scale; the gated tanh-GELU feed-forward ``wo(gelu(wi_0
  x) * wi_1 x)``; pre-norm residual blocks, cross-attention over the
  encoder's output in every decoder layer; an untied LM head with no
  rescaling of its input.
- **BLIP-2** (Li et al., ICML 2023; LAVIS ``blip2_t5``): the frame resized
  bicubic to the ViT's size and CLIP normalised; **EVA ViT-g/14** (Fang et
  al., CVPR 2023; LAVIS ``eva_vit.py``) as BLIP-2 runs it: 14-px patches
  by a strided convolution, a class token first, learned positions, 39
  pre-norm blocks (one qkv projection read as (3, heads, head width),
  softmax(q k^T / sqrt(d)), exact-erf GELU MLP), then the LayerNorm
  ``ln_vision``; the **Q-Former** (BERT-base, post-norm): the 32 learned
  queries through a LayerNorm, then per layer self-attention, every
  second layer from the first cross-attention to the ViT's output, and
  the queries' own feed-forward (exact-erf GELU), each sub-layer's output
  added to its input and normalised; the queries projected to T5's width
  and placed before the question's embeddings, with the encoder's mask
  all ones over them.
- **Greedy decoding** by a full decoder forward at every step, over the
  tokens so far (no cache), starting from the pad id 0.
- **The veto** (upstream VLFM ``base_objectnav_policy.py:326-335``): each
  detection's mask contour painted red on its frame
  (``cv2.drawContours(thickness=2)``: the 3x3 dilation less the 3x3
  erosion, the frame's outside unset for the dilation and set for the
  erosion, as cv2's borders are), the question "Question: Is this
  [a ]<phrase>? Answer:" ("a " unless the phrase ends in "ing") about the
  phrase the detection matched, and the detection kept only when the
  answer starts with "yes". Batched over a frame batch's slots: the valid
  slots first in slot order, ``ceil(n_valid / capacity)`` windows of
  ``capacity`` slots, the last one clamped to end at the last slot, a
  later window's answer overwriting an earlier one's; no capacity (or one
  of every slot) asks every slot in one batch.

How it is written: plain ``torch`` in float32, every matmul with TF32 off,
no kernel, no cache and no batching beyond a window's own. It imports
neither JAX, nor the port, nor the benchmark's frozen copy of the port.
Parameter names and shapes are the port's, so one weight stream
(``benchmark/weights.py``) loads both. The controls' lower precisions are
switches on the same modules: ``tf32=True`` turns TF32 on for the prefix,
and ``lower_matmuls_`` rounds T5's products' operands (TF32, or bfloat16
with the outputs rounded too).

Departures from the published descriptions:

- the resized frame stays float (PIL rounds it to uint8 again);
- the buckets are computed in float64 on the host (the published code
  casts a float32 ``log`` on the device); they agree wherever float32's
  cut is exact, which the tests hold for every distance up to 300;
- the question's ids come from the caller's ``encode_text`` (the port's
  stand-in WordPiece ids: T5's SentencePiece model is not in the
  repository) and "yes" is the caller's ``yes_id``;
- decoding is greedy for ``max_new_tokens`` and only the first token is
  read (LAVIS's ``generate`` defaults to beam search and longer answers);
- inference only: no dropout.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn


CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
PAD_ID = 0
RED = (255, 0, 0)


@dataclass(frozen=True)
class T5Dims:
    vocab_size: int = 32128
    d_model: int = 2048
    d_kv: int = 64
    d_ff: int = 5120
    heads: int = 32
    enc_layers: int = 24
    dec_layers: int = 24
    rel_buckets: int = 32
    rel_max_distance: int = 128
    eps: float = 1e-6


@dataclass(frozen=True)
class ViTDims:
    """EVA ViT-g/14 as BLIP-2 runs it: 39 of its 40 blocks."""

    image_size: int = 224
    patch_size: int = 14
    width: int = 1408
    depth: int = 39
    heads: int = 16
    mlp_dim: int = 6144
    ln_eps: float = 1e-6


@dataclass(frozen=True)
class QFormerDims:
    """BLIP-2's Q-Former: BERT-base with cross-attention every second layer."""

    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    cross_attention_freq: int = 2
    num_queries: int = 32
    vocab_size: int = 30522
    max_position: int = 512
    ln_eps: float = 1e-12


@dataclass(frozen=True)
class Dims:
    """The widths of BLIP-2 with a T5 language model."""

    vit: ViTDims = field(default_factory=ViTDims)
    qformer: QFormerDims = field(default_factory=QFormerDims)
    t5: T5Dims = field(default_factory=T5Dims)

    @staticmethod
    def from_json(widths: Dict[str, Dict]) -> "Dims":
        return Dims(vit=ViTDims(**widths["vit"]), qformer=QFormerDims(**widths["qformer"]),
                    t5=T5Dims(**widths["t5"]))


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 for cuBLAS and cuDNN set to ``tf32`` inside the block."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def same(t: torch.Tensor) -> torch.Tensor:
    return t


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 to the nearest value with TF32's 10-bit mantissa (ties away
    from zero), as the tensor cores read a TF32 operand."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


# --- T5 ----------------------------------------------------------------------------------
def relative_bucket(distance: int, bidirectional: bool, buckets: int, max_distance: int) -> int:
    """T5's bucket of one relative position ``key - query``."""
    out = 0
    if bidirectional:
        buckets //= 2
        if distance > 0:
            out += buckets
        n = abs(distance)
    else:
        n = max(-distance, 0)
    exact = buckets // 2
    if n < exact:
        return out + n
    large = exact + int(math.log(n / exact) / math.log(max_distance / exact) * (buckets - exact))
    return out + min(large, buckets - 1)


def bucket_grid(lq: int, lk: int, bidirectional: bool, buckets: int, max_distance: int) -> torch.Tensor:
    """(lq, lk) int64 buckets of ``key - query``, on the host."""
    return torch.tensor([[relative_bucket(j - i, bidirectional, buckets, max_distance) for j in range(lk)]
                         for i in range(lq)], dtype=torch.int64)


class RMSNorm(nn.Module):
    """T5X's: the mean of squares in float32, the normalised input back in
    its own dtype, then the scale."""

    def __init__(self, dim: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().pow(2).mean(-1, keepdim=True)
        return (x * torch.rsqrt(var + self.eps)).to(x.dtype) * self.weight


class Attention(nn.Module):
    def __init__(self, d: T5Dims, owns_bias: bool, device=None):
        super().__init__()
        self.d = d
        inner = d.heads * d.d_kv
        self.q = nn.Linear(d.d_model, inner, bias=False, device=device)
        self.k = nn.Linear(d.d_model, inner, bias=False, device=device)
        self.v = nn.Linear(d.d_model, inner, bias=False, device=device)
        self.o = nn.Linear(inner, d.d_model, bias=False, device=device)
        if owns_bias:
            self.rel_bias = nn.Parameter(torch.zeros(d.rel_buckets, d.heads, device=device))
        # The two products' operands and outputs, rounded in a control only (``lower_matmuls_``).
        self.operand = self.result = same

    def position_bias(self, lq: int, lk: int, bidirectional: bool) -> torch.Tensor:
        """(1, heads, lq, lk) from this layer's table."""
        grid = bucket_grid(lq, lk, bidirectional, self.d.rel_buckets, self.d.rel_max_distance)
        return self.rel_bias[grid.to(self.rel_bias.device)].permute(2, 0, 1)[None]

    def forward(self, x, kv, allowed, bias=None):
        """``allowed`` (B or 1, 1, Lq or 1, Lk) bool: which keys each query sees."""
        b, lq, _ = x.shape
        lk = kv.shape[1]
        h, dk = self.d.heads, self.d.d_kv
        q = self.q(x).reshape(b, lq, h, dk).transpose(1, 2)
        k = self.k(kv).reshape(b, lk, h, dk).transpose(1, 2)
        v = self.v(kv).reshape(b, lk, h, dk).transpose(1, 2)
        r, res = self.operand, self.result
        scores = res(r(q) @ r(k).transpose(-1, -2))  # T5 has no 1/sqrt(d)
        if bias is not None:
            scores = scores + bias
        scores = scores.masked_fill(~allowed, torch.finfo(scores.dtype).min)
        out = res(r(torch.softmax(scores, dim=-1)) @ r(v))
        return self.o(out.transpose(1, 2).reshape(b, lq, h * dk))


class FeedForward(nn.Module):
    def __init__(self, d: T5Dims, device=None):
        super().__init__()
        self.wi_0 = nn.Linear(d.d_model, d.d_ff, bias=False, device=device)
        self.wi_1 = nn.Linear(d.d_model, d.d_ff, bias=False, device=device)
        self.wo = nn.Linear(d.d_ff, d.d_model, bias=False, device=device)

    def forward(self, x):
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class Block(nn.Module):
    def __init__(self, d: T5Dims, decoder: bool, owns_bias: bool, device=None):
        super().__init__()
        self.ln_self = RMSNorm(d.d_model, d.eps, device)
        self.self_attn = Attention(d, owns_bias, device)
        if decoder:
            self.ln_cross = RMSNorm(d.d_model, d.eps, device)
            self.cross_attn = Attention(d, False, device)
        self.ln_ffn = RMSNorm(d.d_model, d.eps, device)
        self.ffn = FeedForward(d, device)

    def forward(self, x, self_allowed, bias, enc=None, enc_allowed=None):
        y = self.ln_self(x)
        x = x + self.self_attn(y, y, self_allowed, bias)
        if enc is not None:
            x = x + self.cross_attn(self.ln_cross(x), enc, enc_allowed)
        return x + self.ffn(self.ln_ffn(x))


class T5(nn.Module):
    def __init__(self, d: T5Dims, device=None):
        super().__init__()
        self.d = d
        self.embed = nn.Embedding(d.vocab_size, d.d_model, device=device)
        for i in range(d.enc_layers):
            self.add_module(f"enc{i}", Block(d, False, i == 0, device))
        self.enc_final = RMSNorm(d.d_model, d.eps, device)
        for i in range(d.dec_layers):
            self.add_module(f"dec{i}", Block(d, True, i == 0, device))
        self.dec_final = RMSNorm(d.d_model, d.eps, device)
        self.lm_head = nn.Linear(d.d_model, d.vocab_size, bias=False, device=device)

    def encode(self, ids: torch.Tensor, mask: torch.Tensor, prefix: Optional[torch.Tensor] = None):
        """(B, L) ids and bool mask [+ (B, P, d_model) prefix before them] ->
        (the encoder's output (B, P + L, d_model), its mask)."""
        x = self.embed(ids)
        if prefix is not None:
            x = torch.cat([prefix.float(), x], dim=1)
            mask = torch.cat([torch.ones(prefix.shape[:2], dtype=torch.bool, device=mask.device), mask], dim=1)
        n = x.shape[1]
        allowed = mask[:, None, None, :]
        bias = self.enc0.self_attn.position_bias(n, n, bidirectional=True)
        for i in range(self.d.enc_layers):
            x = getattr(self, f"enc{i}")(x, allowed, bias)
        return self.enc_final(x), mask

    def decode(self, tokens: torch.Tensor, enc: torch.Tensor, enc_mask: torch.Tensor) -> torch.Tensor:
        """(B, T) decoder input ids -> (B, T, vocab) logits, every position
        seeing itself and the positions before it."""
        x = self.embed(tokens)
        t = x.shape[1]
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()[None, None]
        bias = self.dec0.self_attn.position_bias(t, t, bidirectional=False)
        enc_allowed = enc_mask[:, None, None, :]
        for i in range(self.d.dec_layers):
            x = getattr(self, f"dec{i}")(x, causal, bias, enc, enc_allowed)
        return self.lm_head(self.dec_final(x))

    def greedy(self, enc: torch.Tensor, enc_mask: torch.Tensor, steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(tokens (B, steps), logits (B, steps, vocab)): step i runs the
        decoder on the i + 1 tokens so far and takes the argmax of its last
        position."""
        tokens = torch.full((enc.shape[0], 1), PAD_ID, dtype=torch.int64, device=enc.device)
        logits = []
        for _ in range(steps):
            last = self.decode(tokens, enc, enc_mask)[:, -1]
            logits.append(last)
            tokens = torch.cat([tokens, last.argmax(dim=-1, keepdim=True)], dim=1)
        return tokens[:, 1:], torch.stack(logits, dim=1)

    def teacher_forced(self, enc: torch.Tensor, enc_mask: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """(B, T, vocab) logits at each position given ``tokens`` (B, T) before it."""
        start = torch.full((tokens.shape[0], 1), PAD_ID, dtype=torch.int64, device=tokens.device)
        return self.decode(torch.cat([start, tokens[:, :-1]], dim=1), enc, enc_mask)


# --- BLIP-2's visual prefix ----------------------------------------------------------------
class LayerNorm(nn.Module):
    """A LayerNorm held as ``ln``, the parameter path the weight stream names."""

    def __init__(self, dim: int, eps: float, device=None):
        super().__init__()
        self.ln = nn.LayerNorm(dim, eps=eps, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln(x)


def heads_attention(q, k, v, allowed=None):
    """(B, H, Lq, D), (B, H, Lk, D) x2 -> (B, Lq, H * D), softmax(q k^T / sqrt(D)) v."""
    scores = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if allowed is not None:
        scores = scores.masked_fill(~allowed, torch.finfo(scores.dtype).min)
    out = torch.softmax(scores, dim=-1) @ v
    b, h, lq, d = out.shape
    return out.transpose(1, 2).reshape(b, lq, h * d)


class ViTAttention(nn.Module):
    """EVA's attention: one qkv projection read as (B, L, 3, H, D)."""

    def __init__(self, d: ViTDims, device=None):
        super().__init__()
        self.heads = d.heads
        self.qkv = nn.Linear(d.width, 3 * d.width, device=device)
        self.proj = nn.Linear(d.width, d.width, device=device)

    def forward(self, x):
        b, n, w = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, w // self.heads).permute(2, 0, 3, 1, 4)
        return self.proj(heads_attention(qkv[0], qkv[1], qkv[2]))


class MLP(nn.Module):
    def __init__(self, width: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden, device=device)
        self.fc2 = nn.Linear(hidden, width, device=device)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class ViTBlock(nn.Module):
    """Pre-norm: x + attn(ln1(x)), then + mlp(ln2(x))."""

    def __init__(self, d: ViTDims, device=None):
        super().__init__()
        self.ln1 = LayerNorm(d.width, d.ln_eps, device)
        self.attn = ViTAttention(d, device)
        self.ln2 = LayerNorm(d.width, d.ln_eps, device)
        self.mlp = MLP(d.width, d.mlp_dim, device)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class ViT(nn.Module):
    """(N, H, W, 3) normalised images -> (N, 1 + patches, width): the
    patches' embedding, the class token first, the learned positions
    added, the blocks and the closing LayerNorm (LAVIS's ``ln_vision``)."""

    def __init__(self, d: ViTDims, device=None):
        super().__init__()
        self.d = d
        patches = (d.image_size // d.patch_size) ** 2
        self.patch_embed = nn.Conv2d(3, d.width, d.patch_size, stride=d.patch_size, device=device)
        self.class_embedding = nn.Parameter(torch.zeros(d.width, device=device))
        self.position_embedding = nn.Parameter(torch.zeros(patches + 1, d.width, device=device))
        for i in range(d.depth):
            self.add_module(f"block{i}", ViTBlock(d, device))
        self.post_ln = LayerNorm(d.width, d.ln_eps, device)

    def forward(self, images):
        x = self.patch_embed(images.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.position_embedding
        for i in range(self.d.depth):
            x = getattr(self, f"block{i}")(x)
        return self.post_ln(x)


class BertAttention(nn.Module):
    """Separate query, key and value projections (the keys and values of
    the cross-attention from the ViT's width), the output projection."""

    def __init__(self, hidden: int, heads: int, kv_width: int, device=None):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(hidden, hidden, device=device)
        self.key = nn.Linear(kv_width, hidden, device=device)
        self.value = nn.Linear(kv_width, hidden, device=device)
        self.out = nn.Linear(hidden, hidden, device=device)

    def forward(self, x, kv):
        def split(t):
            return t.reshape(t.shape[0], t.shape[1], self.heads, -1).transpose(1, 2)

        return self.out(heads_attention(split(self.query(x)), split(self.key(kv)), split(self.value(kv))))


class QFormerLayer(nn.Module):
    """Post-norm BERT layer on the queries: self-attention, cross-attention
    to the image (every ``cross_attention_freq``-th layer), the queries'
    own feed-forward; each sub-layer's output added to its input, then
    normalised."""

    def __init__(self, d: QFormerDims, has_cross: bool, image_width: int, device=None):
        super().__init__()
        self.self_attn = BertAttention(d.hidden, d.heads, d.hidden, device)
        self.self_ln = LayerNorm(d.hidden, d.ln_eps, device)
        self.has_cross = has_cross
        if has_cross:
            self.cross_attn = BertAttention(d.hidden, d.heads, image_width, device)
            self.cross_ln = LayerNorm(d.hidden, d.ln_eps, device)
        self.ffn_query_fc1 = nn.Linear(d.hidden, d.intermediate, device=device)
        self.ffn_query_fc2 = nn.Linear(d.intermediate, d.hidden, device=device)
        self.ffn_query_ln = LayerNorm(d.hidden, d.ln_eps, device)

    def forward(self, x, image):
        x = self.self_ln(x + self.self_attn(x, x))
        if self.has_cross:
            x = self.cross_ln(x + self.cross_attn(x, image))
        return self.ffn_query_ln(x + self.ffn_query_fc2(F.gelu(self.ffn_query_fc1(x))))


class QFormer(nn.Module):
    """The query branch: the queries normalised, then the layers."""

    def __init__(self, d: QFormerDims, image_width: int, device=None):
        super().__init__()
        self.d = d
        self.embed_ln = LayerNorm(d.hidden, d.ln_eps, device)
        for i in range(d.layers):
            self.add_module(f"layer{i}", QFormerLayer(d, i % d.cross_attention_freq == 0, image_width, device))

    def forward(self, queries, image):
        x = self.embed_ln(queries)
        for i in range(self.d.layers):
            x = getattr(self, f"layer{i}")(x, image)
        return x


class VisualPrefix(nn.Module):
    """(N, H, W, 3) float images in [0, 1] at the ViT's size -> (N, queries, d_model)."""

    def __init__(self, d: Dims, device=None):
        super().__init__()
        self.vision = ViT(d.vit, device)
        self.query_tokens = nn.Parameter(torch.zeros(d.qformer.num_queries, d.qformer.hidden, device=device))
        self.qformer = QFormer(d.qformer, d.vit.width, device)
        self.language_projection = nn.Linear(d.qformer.hidden, d.t5.d_model, device=device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        mean = torch.tensor(CLIP_MEAN, device=images.device)
        std = torch.tensor(CLIP_STD, device=images.device)
        image = self.vision((images - mean) / std)
        queries = self.query_tokens.expand(images.shape[0], -1, -1)
        return self.language_projection(self.qformer(queries, image))


def norm_fills(model: nn.Module) -> Dict[str, float]:
    """Every norm's scale 1 and bias 0, by parameter name."""
    out = {}
    for n, m in model.named_modules():
        if isinstance(m, RMSNorm):
            out[f"{n}.weight"] = 1.0
        elif isinstance(m, nn.LayerNorm):
            out.update({f"{n}.weight": 1.0, f"{n}.bias": 0.0})
    return out


class BLIP2T5(nn.Module):
    """The whole model: ``prefix`` and ``t5``, with ``answer`` asking it.
    ``tf32`` turns TF32 on for the prefix (a control's); T5 always runs
    with it off, a control's T5 rounding its own operands
    (``lower_matmuls_``)."""

    def __init__(self, d: Dims, device=None, tf32: bool = False):
        super().__init__()
        self.dims, self.tf32 = d, tf32
        self.prefix = VisualPrefix(d, device)
        self.t5 = T5(d.t5, device)

    def preprocess(self, rgb: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) uint8 -> float [0, 1] at the ViT's size: bicubic
        (Keys, a = -0.5) on half-pixel centres, its kernel widened by the
        factor when shrinking (antialiased), as PIL's BICUBIC resize."""
        s = self.dims.vit.image_size
        x = F.interpolate(rgb.permute(0, 3, 1, 2).float() / 255.0, size=(s, s), mode="bicubic", antialias=True,
                          align_corners=False)
        return x.permute(0, 2, 3, 1)

    @torch.no_grad()
    def image_prefix(self, rgb: torch.Tensor) -> torch.Tensor:
        with matmul_precision(self.tf32):
            return self.prefix(self.preprocess(rgb))

    @torch.no_grad()
    def answer(self, rgb: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor, steps: int) -> Dict[str, torch.Tensor]:
        """Annotated (N, H, W, 3) uint8 frames and their questions -> the
        prefix (N, Q, d_model), the greedy tokens (N, steps) and each step's
        logits (N, steps, vocab)."""
        prefix = self.image_prefix(rgb)
        with matmul_precision(False):
            enc, m = self.t5.encode(ids, mask, prefix)
            tokens, logits = self.t5.greedy(enc, m, steps)
        return {"prefix": prefix, "tokens": tokens, "logits": logits}

    @torch.no_grad()
    def forced(self, prefix: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
               tokens: torch.Tensor) -> torch.Tensor:
        """The logits at every position of ``tokens`` given the prefix and
        question (teacher forcing)."""
        with matmul_precision(False):
            enc, m = self.t5.encode(ids, mask, prefix)
            return self.t5.teacher_forced(enc, m, tokens)


def lower_matmuls_(t5: T5, operand: Callable, result: Callable = same) -> T5:
    """A control's T5: the input of every linear and both operands of each
    attention product through ``operand``, and with ``result`` every
    product's output too, the sums in float32 between (the weights, served
    in bfloat16, are exact in TF32 and in bfloat16 already)."""
    for mod in t5.modules():
        if isinstance(mod, nn.Linear):
            mod.register_forward_pre_hook(lambda m, args: (operand(args[0]), *args[1:]))
            if result is not same:
                mod.register_forward_hook(lambda m, args, out: result(out))
        elif isinstance(mod, Attention):
            mod.operand, mod.result = operand, result
    return t5


# --- the veto -----------------------------------------------------------------------------
def contour_ring(masks: torch.Tensor) -> torch.Tensor:
    """(..., H, W) bool -> the pixels within one pixel of the mask's edge:
    the 3x3 dilation (outside unset) less the 3x3 erosion (outside set)."""
    h, w = masks.shape[-2:]

    def neighbours(fill: bool):
        padded = torch.full((*masks.shape[:-2], h + 2, w + 2), fill, dtype=torch.bool, device=masks.device)
        padded[..., 1:-1, 1:-1] = masks
        return [padded[..., dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]

    grown = torch.zeros_like(masks)
    for n in neighbours(False):
        grown = grown | n
    shrunk = torch.ones_like(masks)
    for n in neighbours(True):
        shrunk = shrunk & n
    return grown & ~shrunk


def annotate(rgb: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 and (B, K, H, W) bool -> (B*K, H, W, 3): slot
    (b, k) is frame b with mask (b, k)'s contour in red."""
    b, k = masks.shape[:2]
    frames = rgb[:, None].expand(b, k, *rgb.shape[1:]).clone()
    frames[contour_ring(masks)] = torch.tensor(RED, dtype=torch.uint8, device=rgb.device)
    return frames.reshape(b * k, *rgb.shape[1:])


def question(phrase: str, prompt: str = "Is this ") -> str:
    article = "" if phrase.endswith("ing") else "a "
    return f"Question: {prompt}{article}{phrase}? Answer:"


def windows(valid: Sequence[bool], capacity: Optional[int]) -> List[List[int]]:
    """The slots each batch asks: all in one, or ``ceil(n_valid /
    capacity)`` windows of the valid-first order, the last clamped."""
    n = len(valid)
    if capacity is None or capacity >= n:
        return [list(range(n))]
    order = sorted(range(n), key=lambda i: not valid[i])  # stable: slot order within each group
    n_valid = sum(bool(v) for v in valid)
    starts = [min(p * capacity, n - capacity) for p in range(-(-n_valid // capacity))]
    return [order[s:s + capacity] for s in starts]


@dataclass
class Veto:
    """The detection veto over a frame batch with ``model``."""

    model: BLIP2T5
    encode_text: Callable  # str -> (ids (L,), mask (L,))
    yes_id: int
    capacity: Optional[int] = None
    max_new_tokens: int = 4
    prompt: str = "Is this "

    def questions(self, phrases: Sequence[str], device) -> Tuple[torch.Tensor, torch.Tensor]:
        enc = [self.encode_text(question(p, self.prompt)) for p in phrases]
        ids = torch.stack([torch.as_tensor(i, dtype=torch.int64) for i, _ in enc]).to(device)
        mask = torch.stack([torch.as_tensor(m, dtype=torch.bool) for _, m in enc]).to(device)
        return ids, mask

    @torch.no_grad()
    def __call__(self, rgb: torch.Tensor, masks: torch.Tensor, valid: torch.Tensor,
                 phrases: Union[str, List[str]], cls: Optional[torch.Tensor] = None):
        """(B, H, W, 3) uint8, (B, K, H, W) bool on the frame's grid, (B, K)
        bool, one phrase or a phrase bank indexed by ``cls`` (B, K) ->
        (the kept validity (B, K), one dict per batch asked: its ``slots``,
        ``frames``, ``ids``, ``mask``, ``prefix``, ``tokens`` and ``logits``)."""
        b, k = valid.shape
        if isinstance(phrases, str):
            phrases = [phrases]
        bank_ids, bank_mask = self.questions(phrases, rgb.device)
        if cls is None or len(phrases) == 1:
            which = [0] * (b * k)
        else:
            which = [min(max(int(c), 0), len(phrases) - 1) for c in cls.reshape(-1).tolist()]
        frames = annotate(rgb, masks)
        yes = [False] * (b * k)
        asked = []
        for slots in windows(valid.reshape(-1).tolist(), self.capacity):
            rows = torch.tensor(slots, device=rgb.device)
            q = torch.tensor([which[s] for s in slots], device=rgb.device)
            out = self.model.answer(frames[rows], bank_ids[q], bank_mask[q], self.max_new_tokens)
            for s, first in zip(slots, out["tokens"][:, 0].tolist()):
                yes[s] = first == self.yes_id
            asked.append({"slots": slots, "frames": frames[rows], "ids": bank_ids[q], "mask": bank_mask[q], **out})
        kept = valid & torch.tensor(yes, device=valid.device).reshape(b, k)
        return kept, asked
