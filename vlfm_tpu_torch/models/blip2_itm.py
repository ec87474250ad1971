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
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from vlfm_tpu_torch.device import default_device
from vlfm_tpu_torch.models.hf_convert import dense, kernel, leaf, norm
from vlfm_tpu_torch.models.layers import Dense
from vlfm_tpu_torch.models.params import init_random_, load_jax_params_, state_dict_from_jax_params  # noqa: F401
from vlfm_tpu_torch.models.qformer import QFormer, QFormerConfig, TextEmbeddings
from vlfm_tpu_torch.models.vit import ViTConfig, ViTEncoder
from vlfm_tpu_torch.ops.resize import resize_matmul
from vlfm_tpu_torch.utils.profiling import span

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
        """(B, H, W, 3) in [0, 1] -> (B, Q, E) normalized query features:
        a ``vlfm.itm.vision`` span (normalisation and ViT), then a
        ``vlfm.itm.qformer`` span (the Q-Former and the projection)."""
        c = self.cfg
        with span("vlfm.itm.vision"):
            with span("vlfm.wait.itm_norm"):
                mean = torch.tensor(CLIP_MEAN, dtype=images.dtype, device=images.device)
            with span("vlfm.wait.itm_norm"):
                std = torch.tensor(CLIP_STD, dtype=images.dtype, device=images.device)
            x = ((images - mean) / std).to(c.compute_dtype)
            embeds = self.vision(x)
        with span("vlfm.itm.qformer"):
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
        """(B, H, W, 3) uint8 -> resized float [0, 1] at model resolution
        (in a ``vlfm.itm.vision`` span)."""
        s = self.cfg.vit.image_size
        with span("vlfm.itm.vision"):
            x = rgb_uint8.to(torch.float32) / 255.0
            return resize_matmul(x, s, s, "cubic")


# ---------------------------------------------------------------------------
# HF checkpoint conversion (Salesforce/blip2-itm-vit-g layout)
# ---------------------------------------------------------------------------
def _ln(sd, name):
    return {"ln": norm(sd, name)}


def convert_vision_tree(sd: Mapping[str, Any], vit_cfg: ViTConfig) -> Dict[str, Any]:
    """``vision_model.*`` (HF Blip2VisionModel, shared by the ITM and the
    conditional-generation checkpoints) -> JAX's ViTEncoder tree."""
    emb = "vision_model.embeddings"
    vit: Dict[str, Any] = {
        "patch_embed": {"kernel": kernel(sd[f"{emb}.patch_embedding.weight"])},
        "class_embedding": leaf(np.asarray(sd[f"{emb}.class_embedding"]).reshape(-1)),
        "position_embedding": leaf(np.asarray(sd[f"{emb}.position_embedding"]).reshape(-1, vit_cfg.width)),
        "post_ln": _ln(sd, "vision_model.post_layernorm"),
    }
    if f"{emb}.patch_embedding.bias" in sd:
        vit["patch_embed"]["bias"] = leaf(sd[f"{emb}.patch_embedding.bias"])
    for i in range(vit_cfg.depth):
        p = f"vision_model.encoder.layers.{i}"
        vit[f"block{i}"] = {
            "ln1": _ln(sd, f"{p}.layer_norm1"),
            "ln2": _ln(sd, f"{p}.layer_norm2"),
            "attn": {"qkv": dense(sd, f"{p}.self_attn.qkv"), "proj": dense(sd, f"{p}.self_attn.projection")},
            "mlp": {"fc1": dense(sd, f"{p}.mlp.fc1"), "fc2": dense(sd, f"{p}.mlp.fc2")},
        }
    return vit


def convert_qformer_tree(sd: Mapping[str, Any], q_cfg: QFormerConfig, *, text_branch: bool = True) -> Dict[str, Any]:
    """``qformer.*`` -> JAX's QFormer tree. The conditional-generation
    checkpoint carries only the query feed-forward branch (no
    ``intermediate``/``output``); the retrieval checkpoint carries both."""
    qf: Dict[str, Any] = {"embed_ln": _ln(sd, "qformer.layernorm")}
    for i in range(q_cfg.layers):
        p = f"qformer.encoder.layer.{i}"
        layer: Dict[str, Any] = {
            "self_attn": {
                "query": dense(sd, f"{p}.attention.attention.query"),
                "key": dense(sd, f"{p}.attention.attention.key"),
                "value": dense(sd, f"{p}.attention.attention.value"),
                "out": dense(sd, f"{p}.attention.output.dense"),
            },
            "self_ln": _ln(sd, f"{p}.attention.output.LayerNorm"),
            "ffn_query_fc1": dense(sd, f"{p}.intermediate_query.dense"),
            "ffn_query_fc2": dense(sd, f"{p}.output_query.dense"),
            "ffn_query_ln": _ln(sd, f"{p}.output_query.LayerNorm"),
        }
        if text_branch:
            layer["ffn_text_fc1"] = dense(sd, f"{p}.intermediate.dense")
            layer["ffn_text_fc2"] = dense(sd, f"{p}.output.dense")
            layer["ffn_text_ln"] = _ln(sd, f"{p}.output.LayerNorm")
        if i % q_cfg.cross_attention_freq == 0:
            layer["cross_attn"] = {
                "query": dense(sd, f"{p}.crossattention.attention.query"),
                "key": dense(sd, f"{p}.crossattention.attention.key"),
                "value": dense(sd, f"{p}.crossattention.attention.value"),
                "out": dense(sd, f"{p}.crossattention.output.dense"),
            }
            layer["cross_ln"] = _ln(sd, f"{p}.crossattention.output.LayerNorm")
        qf[f"layer{i}"] = layer
    return qf


def convert_hf_state_dict(sd: Mapping[str, Any], cfg: BLIP2ITMConfig) -> Dict[str, Any]:
    """A HF Blip2ForImageTextRetrieval state dict -> JAX's BLIP2ITM tree."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    q = cfg.qformer
    return {
        "vision": convert_vision_tree(sd, cfg.vit),
        "qformer": convert_qformer_tree(sd, q, text_branch=True),
        "query_tokens": leaf(sd["query_tokens"].reshape(q.num_queries, q.hidden)),
        "text_embeddings": {
            "word": {"embedding": leaf(sd["embeddings.word_embeddings.weight"])},
            "position": leaf(sd["embeddings.position_embeddings.weight"]),
        },
        "vision_proj": dense(sd, "vision_projection"),
        "text_proj": dense(sd, "text_projection"),
    }
