"""Open-vocabulary object detection (OWL-ViT) as batched GPU inference.

Counterpart of ``vlfm_tpu/models/owl_vit.py``: the detector behind
``_get_object_detections`` (base_objectnav_policy.py:221-241), a dense ViT
over the image and a CLIP text encoder over the class prompts, batched over
images x prompts in one call, in the huggingface
``OwlViTForObjectDetection`` layout of the JAX module.

Every LayerNorm is the port's ``FastLayerNorm``, so on CUDA tensors it runs
K1 (``csrc/layer_norm.cu``): pre_ln, two per layer and post_ln and merge_ln
in one vision pass (27 at 12 layers), two per layer and final_ln in one
text encoding (25). Submodules carry the flax scope names, so
``OwlViTDetector.from_jax_params`` loads a JAX tree through
``params.state_dict_from_jax_params``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vlfm_tpu_torch.device import default_device
from vlfm_tpu_torch.models.layers import Dense, FastLayerNorm
from vlfm_tpu_torch.models.params import init_random_, state_dict_from_jax_params
from vlfm_tpu_torch.ops.resize import resize_bilinear

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass(frozen=True)
class OwlTextConfig:
    hidden: int = 512
    layers: int = 12
    heads: int = 8
    mlp_dim: int = 2048
    vocab_size: int = 49408
    max_position: int = 16


@dataclass(frozen=True)
class OwlVisionConfig:
    image_size: int = 768
    patch_size: int = 32
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


@dataclass(frozen=True)
class OwlViTDetConfig:
    vision: OwlVisionConfig = field(default_factory=OwlVisionConfig)
    text: OwlTextConfig = field(default_factory=OwlTextConfig)
    projection_dim: int = 512
    compute_dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny() -> "OwlViTDetConfig":
        return OwlViTDetConfig(
            vision=OwlVisionConfig(image_size=64, patch_size=8, hidden=32, layers=2, heads=2, mlp_dim=64),
            text=OwlTextConfig(hidden=16, layers=2, heads=2, mlp_dim=32, vocab_size=100, max_position=16),
            projection_dim=16,
        )


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / (||x|| + 1e-6) with the norm taken as sqrt(sum(x * x)) in x's
    dtype, as ``jnp.linalg.norm``."""
    return x / (torch.sqrt((x * x).sum(-1, keepdim=True)) + 1e-6)


class ClipAttention(nn.Module):
    def __init__(self, dim: int, heads: int, causal: bool = False, *, device=None):
        super().__init__()
        self.heads, self.causal = heads, causal
        self.q_proj = Dense(dim, dim, device=device)
        self.k_proj = Dense(dim, dim, device=device)
        self.v_proj = Dense(dim, dim, device=device)
        self.out_proj = Dense(dim, dim, device=device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, l, d = x.shape
        hd = d // self.heads

        def split(t):
            return t.reshape(b, l, self.heads, hd).transpose(1, 2)

        q = split(self.q_proj(x)) * (hd**-0.5)
        logits = torch.matmul(q, split(self.k_proj(x)).transpose(-1, -2))
        if self.causal:
            causal = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
            logits = torch.where(causal[None, None], logits, -1e30)
        if mask is not None:
            logits = torch.where(mask[:, None, None, :], logits, -1e30)
        p = torch.softmax(logits.to(torch.float32), dim=-1).to(x.dtype)
        o = torch.matmul(p, split(self.v_proj(x))).transpose(1, 2).reshape(b, l, d)
        return self.out_proj(o)


class ClipLayer(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_dim: int, causal: bool = False, *, device=None):
        super().__init__()
        self.ln1 = FastLayerNorm(dim, 1e-5, device=device)
        self.attn = ClipAttention(dim, heads, causal, device=device)
        self.ln2 = FastLayerNorm(dim, 1e-5, device=device)
        self.fc1 = Dense(dim, mlp_dim, device=device)
        self.fc2 = Dense(mlp_dim, dim, device=device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), mask)
        return x + self.fc2(quick_gelu(self.fc1(self.ln2(x))))


class OwlTextEncoder(nn.Module):
    def __init__(self, cfg: OwlTextConfig, *, device=None):
        super().__init__()
        self.cfg = c = cfg
        self.token_embed = nn.Embedding(c.vocab_size, c.hidden, device=device)
        self.position_embed = nn.Parameter(torch.zeros(c.max_position, c.hidden, device=device))
        for i in range(c.layers):
            self.add_module(f"layer{i}", ClipLayer(c.hidden, c.heads, c.mlp_dim, causal=True, device=device))
        self.final_ln = FastLayerNorm(c.hidden, 1e-5, device=device)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        x = self.token_embed(input_ids)
        x = x + self.position_embed[None, : input_ids.shape[1]].to(x.dtype)
        for i in range(self.cfg.layers):
            x = getattr(self, f"layer{i}")(x, attention_mask)
        x = self.final_ln(x)
        # CLIP pooling: the feature at the EOT token (the highest token id)
        eot = torch.argmax(input_ids, dim=-1)
        return x[torch.arange(x.shape[0], device=x.device), eot]


class OwlVisionEncoder(nn.Module):
    def __init__(self, cfg: OwlVisionConfig, *, device=None):
        super().__init__()
        self.cfg = c = cfg
        self.patch_embed = nn.Conv2d(3, c.hidden, c.patch_size, c.patch_size, bias=False, device=device)
        self.class_embedding = nn.Parameter(torch.zeros(c.hidden, device=device))
        self.position_embed = nn.Parameter(torch.zeros(c.grid**2 + 1, c.hidden, device=device))
        self.pre_ln = FastLayerNorm(c.hidden, 1e-5, device=device)
        for i in range(c.layers):
            self.add_module(f"layer{i}", ClipLayer(c.hidden, c.heads, c.mlp_dim, device=device))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) normalized -> (B, 1 + patches, hidden); post_ln is
        the detection head's."""
        c = self.cfg
        w = self.patch_embed.weight
        dt = torch.promote_types(images.dtype, w.dtype)
        x = F.conv2d(images.permute(0, 3, 1, 2).to(dt), w.to(dt), stride=c.patch_size)
        x = x.flatten(2).transpose(1, 2)  # (B, patches, hidden), row-major patches
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, c.hidden)
        x = torch.cat([cls, x], dim=1) + self.position_embed[None].to(x.dtype)
        x = self.pre_ln(x)
        for i in range(c.layers):
            x = getattr(self, f"layer{i}")(x)
        return x


class OwlMLPHead(nn.Module):
    def __init__(self, dim: int, out_dim: int, *, device=None):
        super().__init__()
        self.dense0 = Dense(dim, dim, device=device)
        self.dense1 = Dense(dim, dim, device=device)
        self.dense2 = Dense(dim, out_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense2(F.gelu(self.dense1(F.gelu(self.dense0(x)))))


def box_bias(grid: int, device=None) -> torch.Tensor:
    """(P, 4) per-patch logit bias anchoring boxes at the patch centres
    (OwlViT compute_box_bias)."""
    ar = torch.arange(1, grid + 1, device=device)
    xs, ys = torch.meshgrid(ar, ar, indexing="xy")
    coords = (torch.stack([xs, ys], dim=-1).to(torch.float32) / grid).reshape(-1, 2).clamp(0.0, 1.0)
    coord_bias = torch.log(coords + 1e-4) - torch.log1p(-coords + 1e-4)
    size = torch.full_like(coords, 1.0 / grid)
    size_bias = torch.log(size + 1e-4) - torch.log1p(-size + 1e-4)
    return torch.cat([coord_bias, size_bias], dim=-1)


class OwlViTDetectionModule(nn.Module):
    def __init__(self, cfg: OwlViTDetConfig, *, device=None):
        super().__init__()
        self.cfg = c = cfg
        v = c.vision.hidden
        self.vision = OwlVisionEncoder(c.vision, device=device)
        self.text = OwlTextEncoder(c.text, device=device)
        self.post_ln = FastLayerNorm(v, 1e-5, device=device)
        self.merge_ln = FastLayerNorm(v, 1e-5, device=device)
        self.text_projection = Dense(c.text.hidden, c.projection_dim, bias=False, device=device)
        self.box_head = OwlMLPHead(v, 4, device=device)
        self.class_dense = Dense(v, c.projection_dim, device=device)
        self.logit_shift = Dense(v, 1, device=device)
        self.logit_scale = Dense(v, 1, device=device)

    def image_feats(self, images: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) in [0, 1] -> (B, P, D) merged patch features."""
        mean = torch.tensor(CLIP_MEAN, dtype=images.dtype, device=images.device)
        std = torch.tensor(CLIP_STD, dtype=images.dtype, device=images.device)
        h = self.post_ln(self.vision(((images - mean) / std).to(self.cfg.compute_dtype)))
        return self.merge_ln(h[:, 1:] * h[:, :1])

    def text_feats(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        return self.text_projection(self.text(input_ids, attention_mask))

    def forward(self, images, input_ids, attention_mask) -> Tuple[torch.Tensor, torch.Tensor]:
        """(pred_boxes (B, P, 4) cxcywh in [0, 1], logits (B, P, T))."""
        feats = self.image_feats(images)
        boxes = torch.sigmoid(self.box_head(feats) + box_bias(self.cfg.vision.grid, feats.device)[None])
        img_cls = _l2_normalize(self.class_dense(feats))
        txt = _l2_normalize(self.text_feats(input_ids, attention_mask))
        img_cls, txt = (t.to(torch.promote_types(img_cls.dtype, txt.dtype)) for t in (img_cls, txt))
        logits = torch.einsum("bpd,td->bpt", img_cls, txt)
        shift = self.logit_shift(feats)
        scale = F.elu(self.logit_scale(feats)) + 1.0
        return boxes, (logits + shift) * scale


class OwlViTDetector:
    """Detection entry points around an ``OwlViTDetectionModule``
    (inference only)."""

    def __init__(self, cfg: OwlViTDetConfig, module: OwlViTDetectionModule):
        self.cfg = cfg
        self.module = module.eval().requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.module.vision.class_embedding.device

    @classmethod
    def init_random(cls, cfg: OwlViTDetConfig, seed: int = 0,
                    device: torch.device | str = default_device()) -> "OwlViTDetector":
        """Random f32 weights on ``device``, drawn from a seeded generator
        there (the same seed gives other numbers than JAX's init)."""
        module = OwlViTDetectionModule(cfg, device=device)
        init_random_(module, torch.Generator(device=device).manual_seed(seed))
        return cls(cfg, module)

    @classmethod
    def from_jax_params(cls, cfg: OwlViTDetConfig, params_np: Mapping[str, Any],
                        device: torch.device | str = default_device()) -> "OwlViTDetector":
        """Load a ``vlfm_tpu`` OWL-ViT parameter tree given as numpy arrays.
        Every parameter must be present and every shape must match."""
        module = OwlViTDetectionModule(cfg, device=device)
        module.load_state_dict(state_dict_from_jax_params(params_np), strict=True)
        return cls(cfg, module)

    @torch.inference_mode()
    def detect(self, images: torch.Tensor, input_ids: torch.Tensor, attention_mask: torch.Tensor):
        return self.module(images, input_ids, attention_mask)

    def preprocess(self, rgb_uint8: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 -> float [0, 1] at the model resolution."""
        s = self.cfg.vision.image_size
        return resize_bilinear(rgb_uint8.to(torch.float32) / 255.0, s, s)


def top_detections(boxes: torch.Tensor, logits: torch.Tensor, capacity: int, threshold: float = 0.0):
    """Per-image top-K boxes by best-class sigmoid score -> fixed-size
    tensors (boxes_xyxy (B, K, 4), scores (B, K), class_ids (B, K) int32,
    valid (B, K)).

    Ties keep the lower box index first, as ``jax.lax.top_k`` does: a stable
    descending sort, then the first K (``torch.topk`` promises no tie order,
    and sigmoid scores of bf16 logits tie often)."""
    probs = torch.sigmoid(logits)  # (B, P, T)
    best = probs.amax(dim=-1)
    cls = torch.argmax(probs, dim=-1).to(torch.int32)
    scores, idx = torch.sort(best, dim=-1, descending=True, stable=True)
    scores, idx = scores[:, :capacity], idx[:, :capacity]
    take = torch.take_along_dim(boxes, idx[..., None], dim=1)
    cx, cy, w, h = take.unbind(-1)
    xyxy = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1).clamp(0.0, 1.0)
    class_ids = torch.take_along_dim(cls, idx, dim=1)
    return xyxy, scores, class_ids, scores >= threshold
