"""BLIP-2 image-text matching (ITC head) as batched PyTorch inference.

Counterpart of ``vlfm_tpu/models/blip2_itm.py`` (reference:
vlfm/vlm/blip2itm.py, lavis ``blip2_image_text_matching`` with
``match_head="itc"``): cosine(image, text) = max over the Q-Former query
embeddings of the normalized query/text projection dot product, for an
IMAGE BATCH x TEXT BATCH at once. Prompt text features are encoded once and
cached by the caller (``parallel/engine.py``).

Submodules are named after the flax scopes (``vision.block{i}.ln1``,
``qformer.layer{i}.cross_attn``, ...), so ``from_jax_params`` maps a JAX
parameter tree onto this module mechanically.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping

import torch
from torch import nn

from benchmark.frozen.device import default_device
from benchmark.frozen.models.layers import Dense
from benchmark.frozen.models.params import init_random_, load_jax_params_
from benchmark.frozen.models.qformer import QFormer, QFormerConfig, TextEmbeddings
from benchmark.frozen.models.vit import ViTConfig, ViTEncoder
from benchmark.frozen.ops.resize import resize_matmul

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass(frozen=True)
class BLIP2ITMConfig:
    vit: ViTConfig = field(default_factory=ViTConfig)
    qformer: QFormerConfig = field(default_factory=QFormerConfig)
    embed_dim: int = 256
    compute_dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny() -> "BLIP2ITMConfig":
        """Small config for tests/CI."""
        return BLIP2ITMConfig(
            vit=ViTConfig(image_size=56, patch_size=14, width=64, depth=2, heads=4, mlp_dim=128),
            qformer=QFormerConfig(
                hidden=32, layers=2, heads=4, intermediate=64, num_queries=8, vocab_size=100
            ),
            embed_dim=16,
        )


class BLIP2ITMModule(nn.Module):
    def __init__(self, cfg: BLIP2ITMConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        q = cfg.qformer
        self.vision = ViTEncoder(cfg.vit, device=device)
        self.qformer = QFormer(q, cfg.vit.width, device=device)
        self.text_embeddings = TextEmbeddings(q, device=device)
        self.query_tokens = nn.Parameter(torch.zeros(q.num_queries, q.hidden, device=device))
        self.vision_proj = Dense(q.hidden, cfg.embed_dim, device=device)
        self.text_proj = Dense(q.hidden, cfg.embed_dim, device=device)

    def image_feats(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] -> (B, Q, E) normalized query features."""
        c = self.cfg
        mean = torch.tensor(CLIP_MEAN, dtype=images.dtype, device=images.device)
        std = torch.tensor(CLIP_STD, dtype=images.dtype, device=images.device)
        x = ((images - mean) / std).to(c.compute_dtype)
        embeds = self.vision(x)
        b = embeds.shape[0]
        queries = self.query_tokens.to(c.compute_dtype).repeat(b, 1, 1)
        out = self.qformer(queries, image_embeds=embeds, is_query=True)
        feats = self.vision_proj(out.to(torch.float32))
        return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)

    def text_feats(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """(T, L) int ids -> (T, E) normalized CLS features."""
        emb = self.text_embeddings(input_ids).to(self.cfg.compute_dtype)
        out = self.qformer(emb, attention_mask=attention_mask, is_query=False)
        feats = self.text_proj(out[:, 0].to(torch.float32))
        return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)

    def forward(self, images, input_ids, attention_mask) -> torch.Tensor:
        """(B_img, B_txt) ITC cosine matrix (max over query tokens)."""
        return cosine_from_feats(self.image_feats(images), self.text_feats(input_ids, attention_mask))


def cosine_from_feats(img: torch.Tensor, txt: torch.Tensor) -> torch.Tensor:
    """(B, Q, E) x (T, E) -> (B, T): max over queries of the dot product."""
    return torch.einsum("bqe,te->bqt", img, txt).amax(dim=1)


class BLIP2ITM:
    """Scoring entry points around a ``BLIP2ITMModule`` (inference only)."""

    def __init__(self, cfg: BLIP2ITMConfig, module: BLIP2ITMModule):
        self.cfg = cfg
        self.module = module.eval().requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.module.query_tokens.device

    @classmethod
    def init_random(
        cls, cfg: BLIP2ITMConfig, seed: int = 0, device: torch.device | str = default_device()
    ) -> "BLIP2ITM":
        """Random f32 weights on ``device``, drawn from a seeded generator
        there (the same seed gives other numbers than JAX's init)."""
        module = BLIP2ITMModule(cfg, device=device)
        gen = torch.Generator(device=device).manual_seed(seed)
        init_random_(module, gen)
        return cls(cfg, module)

    @classmethod
    def from_jax_params(
        cls, cfg: BLIP2ITMConfig, params_np: Mapping[str, Any], device: torch.device | str = default_device()
    ) -> "BLIP2ITM":
        """Load a ``vlfm_tpu`` BLIP2ITM parameter tree given as numpy arrays.
        Every parameter must be present and every shape must match."""
        module = BLIP2ITMModule(cfg, device=device)
        load_jax_params_(module, params_np)
        return cls(cfg, module)

    @torch.inference_mode()
    def cosine(self, images, input_ids, attention_mask) -> torch.Tensor:
        return self.module(images, input_ids, attention_mask)

    @torch.inference_mode()
    def encode_texts(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        return self.module.text_feats(input_ids, attention_mask)

    @torch.inference_mode()
    def cosine_cached_text(self, images: torch.Tensor, text_feats: torch.Tensor) -> torch.Tensor:
        return cosine_from_feats(self.module.image_feats(images), text_feats)

    def preprocess(self, rgb_uint8: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 -> resized float [0, 1] at model resolution."""
        s = self.cfg.vit.image_size
        x = rgb_uint8.to(torch.float32) / 255.0
        return resize_matmul(x, s, s, "cubic")


# ---------------------------------------------------------------------------
# HF checkpoint conversion (Salesforce/blip2-itm-vit-g layout)
# ---------------------------------------------------------------------------
