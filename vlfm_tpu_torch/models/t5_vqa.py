"""flan-T5 encoder-decoder with greedy decoding: the VQA veto's language model.

Counterpart of ``vlfm_tpu/models/t5_vqa.py`` (reference: vlfm/vlm/blip2.py,
lavis ``blip2_t5`` with flan-t5-xl, asked "Question: Is this a <phrase>?
Answer:" by base_objectnav_policy.py:326-335). T5 v1.1 / flan: RMSNorm
without a mean, a relative-position-bucket bias owned by layer 0 of each
stack and reused by the later layers, no 1/sqrt(d) logit scale, the gated
tanh-GELU feed-forward, an untied LM head. ``encode`` takes an optional
visual ``prefix`` (BLIP-2's projected Q-Former queries) in front of the
text embeddings.

Compute policy, as in JAX under ``cast_for_serving``: the RMSNorm scales
stay f32, so every block's input and every matmul after it is f32 with the
weights upcast; the softmax is f32, then cast to its input's dtype. The
decoding runs under ``precision.exact_f32`` on the card. The bucket table
is computed on the host once per shape (an integer cut of a float ``log``,
whose last ulp may differ between devices) and copied to the device.

No kernel of the JAX package computes T5 (it is plain ``jnp``), so the
port runs it as PyTorch ops. Submodules carry the flax scope names, so
``from_jax_params`` maps a JAX tree mechanically.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vlfm_tpu_torch.device import default_device
from vlfm_tpu_torch.models.hf_convert import kernel, leaf
from vlfm_tpu_torch.models.layers import Dense, Norm, merge_heads, promoted, split_heads
from vlfm_tpu_torch.models.params import init_random_, load_jax_params_
from vlfm_tpu_torch.models.precision import exact_f32
from vlfm_tpu_torch.utils.profiling import count, span


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 1024
    heads: int = 6
    enc_layers: int = 8
    dec_layers: int = 8
    rel_buckets: int = 32
    rel_max_distance: int = 128
    eps: float = 1e-6

    @staticmethod
    def tiny() -> "T5Config":
        return T5Config(vocab_size=100, d_model=32, d_kv=8, d_ff=64, heads=4, enc_layers=2, dec_layers=2)

    @staticmethod
    def flan_xl() -> "T5Config":
        """google/flan-t5-xl, the language stack of the reference's VQA
        model Salesforce/blip2-flan-t5-xl (vlfm/vlm/blip2.py:19-24)."""
        return T5Config(vocab_size=32128, d_model=2048, d_kv=64, d_ff=5120, heads=32, enc_layers=24, dec_layers=24)


class RMSNorm(Norm):
    """``(x * rsqrt(mean(x²) + eps)).to(x.dtype) * scale`` with the mean of
    squares in f32; an f32 scale lifts a bf16 stream to f32, as in flax."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = (x.to(torch.float32) ** 2).mean(-1, keepdim=True)
        return (x * torch.rsqrt(var + self.eps)).to(x.dtype) * self.weight


def relative_position_bucket(rel: torch.Tensor, bidirectional: bool, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """T5's bucket of each relative position ``key - query`` (int tensor):
    exact below half the buckets, logarithmic up to ``max_distance``;
    encoder buckets split by sign, decoder buckets see only the past."""
    ret = torch.zeros_like(rel, dtype=torch.int32)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (rel > 0).to(torch.int32) * num_buckets
        rel = rel.abs()
    else:
        rel = -torch.clamp(rel, max=0)
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    log_ratio = torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32))
    large = max_exact + (
        torch.log(rel.to(torch.float32) / max_exact + 1e-9) / log_ratio * (num_buckets - max_exact)
    ).to(torch.int32)
    large = torch.clamp(large, max=num_buckets - 1)
    return ret + torch.where(is_small, rel.to(torch.int32), large)


@lru_cache(maxsize=64)
def bucket_table(lq: int, lk: int, bidirectional: bool, num_buckets: int, max_distance: int,
                 device: torch.device) -> torch.Tensor:
    """(lq, lk) int64 buckets of ``key - query``, computed on the host and
    copied to ``device`` once per shape (a pageable copy waits for the
    device, so a per-call copy would add a host sync to every pass).
    Callers only read it."""
    rel = torch.arange(lk)[None, :] - torch.arange(lq)[:, None]
    return relative_position_bucket(rel, bidirectional, num_buckets, max_distance).to(torch.int64).to(device)


class T5Attention(nn.Module):
    """Self- or cross-attention. A layer with ``has_rel_bias`` owns the
    stack's (buckets, heads) bias table and returns the bias it built, which
    the later layers reuse."""

    def __init__(self, cfg: T5Config, has_rel_bias: bool = False, bidirectional: bool = True, *, device=None):
        super().__init__()
        c = cfg
        self.cfg, self.has_rel_bias, self.bidirectional = cfg, has_rel_bias, bidirectional
        inner = c.heads * c.d_kv
        self.q = Dense(c.d_model, inner, bias=False, device=device)
        self.k = Dense(c.d_model, inner, bias=False, device=device)
        self.v = Dense(c.d_model, inner, bias=False, device=device)
        self.o = Dense(inner, c.d_model, bias=False, device=device)
        if has_rel_bias:
            self.rel_bias = nn.Parameter(torch.zeros(c.rel_buckets, c.heads, device=device))

    def forward(self, x: torch.Tensor, kv: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
                causal: bool = False, position_bias: Optional[torch.Tensor] = None):
        c = self.cfg
        kv_in = x if kv is None else kv
        lq, lk = x.shape[1], kv_in.shape[1]
        q = split_heads(self.q(x), c.heads)
        k = split_heads(self.k(kv_in), c.heads)
        v = split_heads(self.v(kv_in), c.heads)
        q, k = promoted(q, k)
        logits = torch.matmul(q, k.transpose(-1, -2))  # T5: no 1/sqrt(d)
        if self.has_rel_bias and position_bias is None:
            table = bucket_table(lq, lk, self.bidirectional, c.rel_buckets, c.rel_max_distance, x.device)
            position_bias = self.rel_bias[table].permute(2, 0, 1)[None]  # (1, heads, lq, lk)
        if position_bias is not None:
            logits = logits + position_bias
        if causal:
            cm = torch.ones((lq, lk), dtype=torch.bool, device=x.device).tril(lk - lq)
            logits = torch.where(cm[None, None], logits, -1e30)
        if mask is not None:
            logits = torch.where(mask[:, None, None, :], logits, -1e30)
        p = torch.softmax(logits.to(torch.float32), dim=-1).to(x.dtype)
        p, v = promoted(p, v)
        return self.o(merge_heads(torch.matmul(p, v))), position_bias


class T5FFN(nn.Module):
    """Gated feed-forward: wo(gelu_tanh(wi_0 x) * wi_1 x)."""

    def __init__(self, cfg: T5Config, *, device=None):
        super().__init__()
        self.wi_0 = Dense(cfg.d_model, cfg.d_ff, bias=False, device=device)
        self.wi_1 = Dense(cfg.d_model, cfg.d_ff, bias=False, device=device)
        self.wo = Dense(cfg.d_ff, cfg.d_model, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, is_decoder: bool, has_rel_bias: bool, *, device=None):
        super().__init__()
        self.is_decoder = is_decoder
        self.ln_self = RMSNorm(cfg.d_model, cfg.eps, device=device)
        self.self_attn = T5Attention(cfg, has_rel_bias, bidirectional=not is_decoder, device=device)
        if is_decoder:
            self.ln_cross = RMSNorm(cfg.d_model, cfg.eps, device=device)
            self.cross_attn = T5Attention(cfg, device=device)
        self.ln_ffn = RMSNorm(cfg.d_model, cfg.eps, device=device)
        self.ffn = T5FFN(cfg, device=device)

    def forward(self, x, enc=None, self_mask=None, enc_mask=None, position_bias=None):
        a, position_bias = self.self_attn(self.ln_self(x), mask=self_mask, causal=self.is_decoder,
                                          position_bias=position_bias)
        x = x + a
        if self.is_decoder:
            a, _ = self.cross_attn(self.ln_cross(x), kv=enc, mask=enc_mask)
            x = x + a
        return x + self.ffn(self.ln_ffn(x)), position_bias


class T5Module(nn.Module):
    def __init__(self, cfg: T5Config, *, device=None):
        super().__init__()
        c = self.cfg = cfg
        self.embed = nn.Embedding(c.vocab_size, c.d_model, device=device)
        for i in range(c.enc_layers):
            self.add_module(f"enc{i}", T5Block(c, False, has_rel_bias=i == 0, device=device))
        self.enc_final = RMSNorm(c.d_model, c.eps, device=device)
        for i in range(c.dec_layers):
            self.add_module(f"dec{i}", T5Block(c, True, has_rel_bias=i == 0, device=device))
        self.dec_final = RMSNorm(c.d_model, c.eps, device=device)
        self.lm_head = Dense(c.d_model, c.vocab_size, bias=False, device=device)

    def encode(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
               prefix: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, L) ids and bool mask [+ (B, P, d_model) prefix] ->
        (encoder output (B, P + L, d_model), its mask)."""
        x = self.embed(input_ids)
        if prefix is not None:
            x = torch.cat(promoted(prefix, x), dim=1)
            attention_mask = torch.cat(
                [torch.ones(prefix.shape[:2], dtype=torch.bool, device=prefix.device), attention_mask], dim=1)
        bias = None
        for i in range(self.cfg.enc_layers):
            x, bias = getattr(self, f"enc{i}")(x, self_mask=attention_mask, position_bias=bias)
        return self.enc_final(x), attention_mask

    def decode_logits(self, dec_ids: torch.Tensor, enc_out: torch.Tensor, enc_mask: torch.Tensor) -> torch.Tensor:
        """(B, T) decoder ids -> (B, T, vocab) logits."""
        x = self.embed(dec_ids)
        bias = None
        for i in range(self.cfg.dec_layers):
            x, bias = getattr(self, f"dec{i}")(x, enc=enc_out, enc_mask=enc_mask, position_bias=bias)
        return self.lm_head(self.dec_final(x))

    def forward(self, input_ids, attention_mask, decoder_ids):
        enc, m = self.encode(input_ids, attention_mask)
        return self.decode_logits(decoder_ids, enc, m)


class T5VQA:
    """Greedy decoding around a ``T5Module``. The decoder starts from PAD
    (id 0); EOS is id 1."""

    PAD_ID = 0
    EOS_ID = 1

    def __init__(self, cfg: T5Config, module: T5Module):
        self.cfg = cfg
        self.module = module.eval().requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.module.embed.weight.device

    @classmethod
    def init_random(cls, cfg: T5Config, seed: int = 0, device: torch.device | str = default_device()) -> "T5VQA":
        """Random f32 weights on ``device`` from a seeded generator there:
        lecun-normal kernels, N(0, 1/d_model) embeddings, N(0, 1) bias
        tables, unit scales, and the query kernels scaled by 1/sqrt(d_kv),
        as T5's own initialisation scales them (HF
        ``T5PreTrainedModel._init_weights``): T5 has no logit scale, so
        lecun queries would make a random model's softmax nearly one-hot
        and its answers jump with the last bits of its input. The same
        seed gives other numbers than JAX's init."""
        module = T5Module(cfg, device=device)
        init_random_(module, torch.Generator(device=device).manual_seed(seed), {"rel_bias": 1.0})
        with torch.no_grad():
            for name, p in module.named_parameters():
                if name.endswith("attn.q.weight"):
                    p.mul_(cfg.d_kv**-0.5)
        return cls(cfg, module)

    @classmethod
    def from_jax_params(cls, cfg: T5Config, params_np: Mapping[str, Any],
                        device: torch.device | str = default_device()) -> "T5VQA":
        """Load a ``vlfm_tpu`` T5 parameter tree given as numpy arrays. Every
        parameter must be present and every shape must match."""
        module = T5Module(cfg, device=device)
        load_jax_params_(module, params_np)
        return cls(cfg, module)

    @torch.inference_mode()
    def generate(self, input_ids: torch.Tensor, attention_mask: torch.Tensor, max_new_tokens: int = 8,
                 prefix: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, L) ids and mask [+ (B, P, d_model) visual prefix] -> (B,
        max_new_tokens) greedy tokens. As in JAX, each step runs the whole
        (max_new_tokens + 1)-token decoder and reads the logits at its
        position (a causal decoder: later tokens do not reach them).

        Spans ``vlfm.t5.encode`` (the encoder) and ``vlfm.t5.decode`` (the
        greedy loop); counters ``t5.encoder_tokens`` (rows times the
        encoder's length, prefix included) and ``t5.decode_steps``
        (``max_new_tokens``), per call."""
        with exact_f32(input_ids.device):
            with span("vlfm.t5.encode", ids=input_ids):
                enc, m = self.module.encode(input_ids, attention_mask, prefix)
            count("t5.encoder_tokens", enc.shape[0] * enc.shape[1])
            tokens = torch.zeros((input_ids.shape[0], max_new_tokens + 1), dtype=torch.int64,
                                 device=input_ids.device)
            with span("vlfm.t5.decode", steps=max_new_tokens):
                for i in range(max_new_tokens):
                    logits = self.module.decode_logits(tokens, enc, m)
                    tokens[:, i + 1] = torch.argmax(logits[:, i], dim=-1)
            count("t5.decode_steps", max_new_tokens)
        return tokens[:, 1:]

    @staticmethod
    def answer_starts_with_yes(generated: torch.Tensor, yes_token_id: int) -> torch.Tensor:
        """The reference's veto test, answer.lower().startswith('yes')
        (base_objectnav_policy.py:334): the first token is the yes token."""
        return generated[:, 0] == yes_token_id


# ---------------------------------------------------------------------------
# HF conversion (google/flan-t5-* layout)
# ---------------------------------------------------------------------------
def convert_hf_t5(sd: Mapping[str, Any], cfg: T5Config) -> Dict[str, Any]:
    """A HF T5ForConditionalGeneration state dict -> JAX's T5 tree (no
    biases; the first block of each stack holds the relative-position
    bias table)."""
    sd = {k: np.asarray(v) for k, v in sd.items()}

    def w(name):
        return {"kernel": kernel(sd[f"{name}.weight"])}

    def scale(name):
        return {"scale": leaf(sd[f"{name}.weight"])}

    def attn(prefix, has_bias):
        out = {k: w(f"{prefix}.{k}") for k in ("q", "k", "v", "o")}
        if has_bias:
            out["rel_bias"] = leaf(sd[f"{prefix}.relative_attention_bias.weight"])
        return out

    def ffn(prefix):
        return {k: w(f"{prefix}.DenseReluDense.{k}") for k in ("wi_0", "wi_1", "wo")}

    p: Dict[str, Any] = {
        "embed": {"embedding": leaf(sd["shared.weight"])},
        "enc_final": scale("encoder.final_layer_norm"),
        "dec_final": scale("decoder.final_layer_norm"),
        "lm_head": w("lm_head"),
    }
    for i in range(cfg.enc_layers):
        b = f"encoder.block.{i}"
        p[f"enc{i}"] = {
            "self_attn": attn(f"{b}.layer.0.SelfAttention", i == 0),
            "ln_self": scale(f"{b}.layer.0.layer_norm"),
            "ffn": ffn(f"{b}.layer.1"),
            "ln_ffn": scale(f"{b}.layer.1.layer_norm"),
        }
    for i in range(cfg.dec_layers):
        b = f"decoder.block.{i}"
        p[f"dec{i}"] = {
            "self_attn": attn(f"{b}.layer.0.SelfAttention", i == 0),
            "ln_self": scale(f"{b}.layer.0.layer_norm"),
            "cross_attn": attn(f"{b}.layer.1.EncDecAttention", False),
            "ln_cross": scale(f"{b}.layer.1.layer_norm"),
            "ffn": ffn(f"{b}.layer.2"),
            "ln_ffn": scale(f"{b}.layer.2.layer_norm"),
        }
    return p
