"""Q-Former: BERT encoder with learned query tokens and periodic
cross-attention to vision features (HF Blip2QFormerModel layout).

Counterpart of ``vlfm_tpu/models/qformer.py``. Two operating modes:
- image branch: the learned query tokens self-attend and cross-attend to the
  ViT output every ``cross_attention_freq`` layers, through the ``*_query``
  feed-forward branch;
- text branch: post-LN BERT over token embeddings (no cross-attention,
  shared self-attention weights, the text feed-forward branch).

A Q-Former built with ``text_branch=False`` (BLIP-2's VQA bridge, which only
runs the query branch) has no text feed-forward parameters, as the JAX tree
of that model has none.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.frozen.models.layers import BertAttention, Dense, LayerNormF32


@dataclass(frozen=True)
class QFormerConfig:
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    cross_attention_freq: int = 2
    num_queries: int = 32
    vocab_size: int = 30522
    max_position: int = 512
    ln_eps: float = 1e-12


class QFormerLayer(nn.Module):
    def __init__(self, cfg: QFormerConfig, has_cross: bool, encoder_width: int, text_branch: bool = True, *,
                 device=None):
        super().__init__()
        c = cfg
        self.has_cross = has_cross
        self.self_attn = BertAttention(c.hidden, c.heads, device=device)
        self.self_ln = LayerNormF32(c.hidden, c.ln_eps, device=device)
        if has_cross:
            self.cross_attn = BertAttention(c.hidden, c.heads, encoder_width, device=device)
            self.cross_ln = LayerNormF32(c.hidden, c.ln_eps, device=device)
        for branch in ("query", "text") if text_branch else ("query",):
            self.add_module(f"ffn_{branch}_fc1", Dense(c.hidden, c.intermediate, device=device))
            self.add_module(f"ffn_{branch}_fc2", Dense(c.intermediate, c.hidden, device=device))
            self.add_module(f"ffn_{branch}_ln", LayerNormF32(c.hidden, c.ln_eps, device=device))

    def forward(
        self,
        x: torch.Tensor,
        image_embeds: Optional[torch.Tensor],
        self_mask: Optional[torch.Tensor],
        is_query: bool,
    ) -> torch.Tensor:
        # Post-LN: each residual add runs in its norm's launch, and the sum
        # itself is never kept.
        a = self.self_attn(x, mask=self_mask)
        x = self.self_ln(a, x)
        if self.has_cross and is_query:
            if image_embeds is None:
                raise ValueError("the query branch needs image_embeds")
            ca = self.cross_attn(x, kv=image_embeds)
            x = self.cross_ln(ca, x)
        branch = "query" if is_query else "text"
        h = getattr(self, f"ffn_{branch}_fc1")(x)
        h = getattr(self, f"ffn_{branch}_fc2")(F.gelu(h))
        return getattr(self, f"ffn_{branch}_ln")(h, x)


class QFormer(nn.Module):
    def __init__(self, cfg: QFormerConfig, encoder_width: int, text_branch: bool = True, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed_ln = LayerNormF32(cfg.hidden, cfg.ln_eps, device=device)
        for i in range(cfg.layers):
            has_cross = i % cfg.cross_attention_freq == 0
            self.add_module(
                f"layer{i}", QFormerLayer(cfg, has_cross, encoder_width, text_branch, device=device)
            )

    def forward(
        self,
        inputs: torch.Tensor,  # (B, L, hidden) query tokens OR token embeddings
        image_embeds: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,  # (B, L) bool
        is_query: bool = True,
    ) -> torch.Tensor:
        x = self.embed_ln(inputs)
        self_mask = None if attention_mask is None else attention_mask[:, None, None, :]
        for i in range(self.cfg.layers):
            x = getattr(self, f"layer{i}")(x, image_embeds, self_mask, is_query)
        return x


class TextEmbeddings(nn.Module):
    def __init__(self, cfg: QFormerConfig, *, device=None):
        super().__init__()
        self.word = nn.Embedding(cfg.vocab_size, cfg.hidden, device=device)
        self.position = nn.Parameter(torch.zeros(cfg.max_position, cfg.hidden, device=device))

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:  # (B, L) int
        w = self.word(input_ids)
        return w + self.position[None, : input_ids.shape[1]].to(w.dtype)
