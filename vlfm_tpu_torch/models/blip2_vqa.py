"""BLIP-2 VQA: the visual bridge into the T5 language model.

Counterpart of ``vlfm_tpu/models/blip2_vqa.py`` (reference: the BLIP-2 VQA
server, vlfm/vlm/blip2.py:35-55, lavis ``blip2_t5`` with flan-t5-xl): image
-> CLIP normalisation -> EVA ViT -> Q-Former query tokens -> language
projection -> prepended to the question's embeddings in flan-T5, which
generates the answer. The detection veto (``parallel/detection_pipeline.py``,
base_objectnav_policy.py:326-335) asks it "Question: Is this a <phrase>?
Answer:".

The ViT and the Q-Former are the ITM slice's modules (``models/vit.py``,
``models/qformer.py``; the Q-Former without its text branch), so on the
card every prefix runs K1 (110 LayerNorms at ViT-g) and K3 (39 attentions).
The ViT and Q-Former compute in ``compute_dtype``; ``language_projection``
takes the f32 Q-Former output, so the prefix, and T5 after it, are f32.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from vlfm_tpu_torch.device import default_device
from vlfm_tpu_torch.models.blip2_itm import CLIP_MEAN, CLIP_STD, convert_qformer_tree, convert_vision_tree
from vlfm_tpu_torch.models.hf_convert import dense, leaf
from vlfm_tpu_torch.models.layers import Dense
from vlfm_tpu_torch.models.params import init_random_, load_jax_params_
from vlfm_tpu_torch.models.qformer import QFormer, QFormerConfig
from vlfm_tpu_torch.models.t5_vqa import T5Config, T5VQA, convert_hf_t5
from vlfm_tpu_torch.models.vit import ViTConfig, ViTEncoder
from vlfm_tpu_torch.ops.resize import resize_matmul
from vlfm_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class BLIP2VQAConfig:
    vit: ViTConfig = field(default_factory=ViTConfig)
    qformer: QFormerConfig = field(default_factory=QFormerConfig)
    t5: T5Config = field(default_factory=T5Config)
    compute_dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny() -> "BLIP2VQAConfig":
        return BLIP2VQAConfig(
            vit=ViTConfig(image_size=56, patch_size=14, width=64, depth=2, heads=4, mlp_dim=128),
            qformer=QFormerConfig(hidden=32, layers=2, heads=4, intermediate=64, num_queries=8, vocab_size=100),
            t5=T5Config.tiny(),
            compute_dtype=torch.float32,
        )

    @staticmethod
    def production() -> "BLIP2VQAConfig":
        """Salesforce/blip2-flan-t5-xl: EVA ViT-g, the BERT-base Q-Former
        with 32 queries and flan-t5-xl, the composition the reference
        serves for the veto (vlfm/vlm/blip2.py:19-24). The ViT and Q-Former
        defaults are the production sizes, shared with BLIP2-ITM."""
        return BLIP2VQAConfig(t5=T5Config.flan_xl())


class BLIP2VisualPrefixModule(nn.Module):
    """(B, H, W, 3) images in [0, 1] -> (B, Q, t5.d_model) projected query
    tokens."""

    def __init__(self, cfg: BLIP2VQAConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        q = cfg.qformer
        self.vision = ViTEncoder(cfg.vit, device=device)
        self.query_tokens = nn.Parameter(torch.zeros(q.num_queries, q.hidden, device=device))
        self.qformer = QFormer(q, cfg.vit.width, text_branch=False, device=device)
        self.language_projection = Dense(q.hidden, cfg.t5.d_model, device=device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        with span("vlfm.wait.vqa_norm"):
            mean = torch.tensor(CLIP_MEAN, dtype=images.dtype, device=images.device)
        with span("vlfm.wait.vqa_norm"):
            std = torch.tensor(CLIP_STD, dtype=images.dtype, device=images.device)
        x = ((images - mean) / std).to(c.compute_dtype)
        embeds = self.vision(x)
        queries = self.query_tokens.to(c.compute_dtype).repeat(embeds.shape[0], 1, 1)
        out = self.qformer(queries, image_embeds=embeds, is_query=True)
        return self.language_projection(out.to(torch.float32))


class BLIP2VQA:
    """The veto's model: ``ask`` is the visual prefix, then T5's greedy
    decoding."""

    def __init__(self, cfg: BLIP2VQAConfig, module: BLIP2VisualPrefixModule, t5: T5VQA):
        self.cfg = cfg
        self.module = module.eval().requires_grad_(False)
        self.t5 = t5

    @property
    def device(self) -> torch.device:
        return self.module.query_tokens.device

    @classmethod
    def init_random(cls, cfg: BLIP2VQAConfig, seed: int = 0,
                    device: torch.device | str = default_device()) -> "BLIP2VQA":
        """Random f32 weights for both halves on ``device``, each drawn from
        a generator seeded with ``seed`` there (the same seed gives other
        numbers than JAX's init)."""
        module = BLIP2VisualPrefixModule(cfg, device=device)
        init_random_(module, torch.Generator(device=device).manual_seed(seed))
        return cls(cfg, module, T5VQA.init_random(cfg.t5, seed=seed, device=device))

    @classmethod
    def from_jax_params(cls, cfg: BLIP2VQAConfig, prefix_params_np: Mapping[str, Any],
                        t5_params_np: Mapping[str, Any], device: torch.device | str = default_device()) -> "BLIP2VQA":
        """Load a ``vlfm_tpu`` BLIP2VQA's two trees (the visual prefix's and
        T5's) given as numpy arrays. Every parameter must be present and
        every shape must match."""
        module = BLIP2VisualPrefixModule(cfg, device=device)
        load_jax_params_(module, prefix_params_np)
        return cls(cfg, module, T5VQA.from_jax_params(cfg.t5, t5_params_np, device=device))

    @torch.inference_mode()
    def image_prefix(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) float [0, 1] at model resolution -> (B, Q, d_model)."""
        return self.module(images)

    def preprocess(self, rgb_uint8: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 -> float [0, 1] at model resolution (cubic)."""
        s = self.cfg.vit.image_size
        return resize_matmul(rgb_uint8.to(torch.float32) / 255.0, s, s, "cubic")

    def ask(self, rgb_uint8: torch.Tensor, input_ids: torch.Tensor, attention_mask: torch.Tensor,
            max_new_tokens: int = 8) -> torch.Tensor:
        """(B, H, W, 3) uint8 frames and their tokenized questions ->
        generated token ids (B, max_new_tokens): the blip2_t5 ``generate``
        composition (vlfm/vlm/blip2.py:35-55)."""
        prefix = self.image_prefix(self.preprocess(rgb_uint8))
        return self.t5.generate(input_ids, attention_mask, max_new_tokens=max_new_tokens, prefix=prefix)


def convert_hf_blip2_t5(sd: Mapping[str, Any], cfg: BLIP2VQAConfig) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A HF Blip2ForConditionalGeneration state dict (the flan-T5 text
    stack) -> JAX's (visual-prefix tree, T5 tree)."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    q = cfg.qformer
    prefix = {
        "vision": convert_vision_tree(sd, cfg.vit),
        "qformer": convert_qformer_tree(sd, q, text_branch=False),
        "query_tokens": leaf(sd["query_tokens"].reshape(q.num_queries, q.hidden)),
        "language_projection": dense(sd, "language_projection"),
    }
    lm = "language_model."
    return prefix, convert_hf_t5({k[len(lm):]: v for k, v in sd.items() if k.startswith(lm)}, cfg.t5)


def load_blip2_vqa(sd: Mapping[str, Any], cfg: BLIP2VQAConfig,
                   device: torch.device | str = default_device()) -> BLIP2VQA:
    """A HF Blip2ForConditionalGeneration state dict as a ``BLIP2VQA`` on
    ``device``."""
    return BLIP2VQA.from_jax_params(cfg, *convert_hf_blip2_t5(sd, cfg), device=device)
