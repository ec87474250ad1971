"""ZoeDepth monocular metric depth: BEiT backbone, DPT neck, metric-bins head.

Counterpart of ``vlfm_tpu/models/zoedepth.py`` (reference: the robot stack's
torch-hub ZoeDepth ZoeD_NK, vlfm/policy/reality_policies.py:40-42,156-169;
layout of HF ``ZoeDepthForDepthEstimation``):

- BEiT backbone: a relative-position bias table per layer, layer scale
  (``lambda_1``, ``lambda_2``), a key projection without bias, the CLS
  token read out by the neck;
- DPT neck: reassemble (readout "project", then a per-stage 1x1 conv and a
  transposed-conv or strided-conv rescale), 3x3 convs, fusion with
  pre-activation residual units;
- relative head and metric-bins head: seed bin regressor, attractor layers
  ("mean" or "sum", softplus or "normed" bin centres), the conditional
  log-binomial over bin centres;
- NK's two-domain head with its patch-transformer router: both domains'
  depths are computed, and each lane takes the one its own domain logits
  choose. (JAX and upstream vote once over the batch; at B = 1, the
  reference robot's one camera, the two agree, and a lane's depth does not
  depend on its batch here.)

Maps are channels-last (B, H, W, C), as in JAX; the convolutions permute
to PyTorch's layout and back. Each resize keeps its own corner convention
(``resize_corners``). Under ``cast_for_serving`` the stream stays f32 (the
input pixels are f32, and every product promotes against the bf16
weights), and ``predict`` runs under ``precision.exact_f32`` on the card.
No kernel of the JAX package computes ZoeDepth (it is plain flax), so the
port runs it as PyTorch ops. A HF ZoeDepthForDepthEstimation state dict
converts to JAX's tree through ``convert_hf_zoedepth`` (below), which
``ZoeDepth.from_jax_params`` loads.
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
from vlfm_tpu_torch.models.layers import Dense, LayerNorm, merge_heads, promoted, split_heads
from vlfm_tpu_torch.models.params import init_random_, load_jax_params_
from vlfm_tpu_torch.models.precision import exact_f32
from vlfm_tpu_torch.models.tinyvit import conv_nhwc
from vlfm_tpu_torch.ops.resize import resize_bilinear, resize_bilinear_hw
from vlfm_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class BeitConfig:
    image_size: int = 384
    patch_size: int = 16
    hidden_size: int = 1024
    layers: int = 24
    heads: int = 16
    intermediate: int = 4096
    layer_scale_init: float = 0.1
    layer_norm_eps: float = 1e-12
    out_indices: Tuple[int, ...] = (6, 12, 18, 24)  # 1-based layer index


@dataclass(frozen=True)
class ZoeDepthConfig:
    beit: BeitConfig = field(default_factory=BeitConfig)
    reassemble_factors: Tuple[float, ...] = (4, 2, 1, 0.5)
    neck_hidden_sizes: Tuple[int, ...] = (256, 512, 1024, 1024)
    fusion_hidden_size: int = 256
    num_relative_features: int = 32
    bottleneck_features: int = 256
    num_attractors: Tuple[int, ...] = (16, 8, 4, 1)
    bin_embedding_dim: int = 128
    attractor_alpha: float = 1000.0
    attractor_gamma: float = 2.0
    attractor_kind: str = "mean"  # or "sum"
    min_temp: float = 0.0212
    max_temp: float = 50.0
    bin_centers_type: str = "softplus"  # or "normed"
    # (name, n_bins, min_depth, max_depth) per domain; two or more route (NK)
    bin_configurations: Tuple[Tuple[str, int, float, float], ...] = (("nyu", 64, 1e-3, 10.0),)
    # the router's patch transformer (two or more domains only)
    patch_transformer_layers: int = 4
    patch_transformer_hidden: int = 128
    patch_transformer_intermediate: int = 1024
    patch_transformer_heads: int = 4

    @staticmethod
    def nk() -> "ZoeDepthConfig":
        """ZoeD_NK (Intel/zoedepth-nyu-kitti): two metric heads and the
        router, the model the reference robot loads (reality_policies.py:41)."""
        return ZoeDepthConfig(bin_configurations=(("nyu", 64, 1e-3, 10.0), ("kitti", 64, 1e-3, 80.0)))

    @staticmethod
    def tiny_test() -> "ZoeDepthConfig":
        return ZoeDepthConfig(
            beit=BeitConfig(image_size=64, patch_size=16, hidden_size=32, layers=4, heads=2, intermediate=64,
                            out_indices=(1, 2, 3, 4)),
            neck_hidden_sizes=(16, 24, 32, 32),
            fusion_hidden_size=32,
            num_relative_features=8,
            bottleneck_features=32,
            num_attractors=(4, 2, 2, 1),
            bin_embedding_dim=16,
            bin_configurations=(("nyu", 8, 1e-3, 10.0),),
            patch_transformer_hidden=16,
            patch_transformer_intermediate=32,
            patch_transformer_heads=2,
        )


class Conv(nn.Conv2d):
    """flax's ``nn.Conv`` on a channels-last map, in the promoted dtype of
    input and weight."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(x, self.weight, self.bias, self.stride[0], self.padding[0])


class ConvTranspose(nn.ConvTranspose2d):
    """flax's ``nn.ConvTranspose(transpose_kernel=True)`` on a channels-last
    map (stride = kernel, no padding), in the promoted dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(dt), self.weight.to(dt), self.bias.to(dt),
                               stride=self.stride)
        return y.permute(0, 2, 3, 1).contiguous()


def resize_corners(x: torch.Tensor, size: Tuple[int, int], align_corners: bool) -> torch.Tensor:
    """(..., H, W, C) -> (..., h, w, C) bilinearly, with ``F.interpolate``'s
    two corner conventions, as two gathers and blends."""
    h, w = x.shape[-3], x.shape[-2]
    if tuple(size) == (h, w):
        return x

    def axis_coords(n_in, n_out):
        if align_corners:
            if n_out == 1:
                return torch.zeros(1, device=x.device)
            return torch.arange(n_out, dtype=torch.float32, device=x.device) * ((n_in - 1) / (n_out - 1))
        c = (torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5) * (n_in / n_out) - 0.5
        return torch.clamp(c, 0.0, n_in - 1)

    def interp_axis(arr, coords, axis):
        lo = torch.floor(coords).to(torch.int64)
        hi = torch.clamp(lo + 1, max=arr.shape[axis] - 1)
        t = (coords - lo).to(arr.dtype)
        a, b = arr.index_select(axis, lo), arr.index_select(axis, hi)
        shape = [1] * arr.ndim
        shape[axis] = -1
        return a + (b - a) * t.reshape(shape)

    x = interp_axis(x, axis_coords(h, size[0]), x.ndim - 3)
    return interp_axis(x, axis_coords(w, size[1]), x.ndim - 2)


def _up2(x: torch.Tensor) -> torch.Tensor:
    return resize_corners(x, (2 * x.shape[1], 2 * x.shape[2]), align_corners=True)


# --- BEiT backbone -------------------------------------------------------------
def beit_rel_pos_index(wh: int, ww: int) -> np.ndarray:
    """(N+1, N+1) index into the (2wh-1)(2ww-1)+3 bias table
    (BeitRelativePositionBias.generate_relative_position_index)."""
    num_rel = (2 * wh - 1) * (2 * ww - 1) + 3
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).copy()
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    n = wh * ww
    idx = np.zeros((n + 1, n + 1), np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, :] = num_rel - 3
    idx[:, 0] = num_rel - 2
    idx[0, 0] = num_rel - 1
    return idx


class BeitLayer(nn.Module):
    def __init__(self, c: BeitConfig, *, device=None):
        super().__init__()
        d, nh = c.hidden_size, c.heads
        grid = c.image_size // c.patch_size
        self.heads = nh
        self.ln_before = LayerNorm(d, c.layer_norm_eps, device=device)
        self.q = Dense(d, d, device=device)
        self.k = Dense(d, d, bias=False, device=device)  # BEiT: no key bias
        self.v = Dense(d, d, device=device)
        self.rel_pos_table = nn.Parameter(torch.zeros((2 * grid - 1) ** 2 + 3, nh, device=device))
        self.proj = Dense(d, d, device=device)
        self.lambda_1 = nn.Parameter(torch.full((d,), c.layer_scale_init, device=device))
        self.ln_after = LayerNorm(d, c.layer_norm_eps, device=device)
        self.fc1 = Dense(d, c.intermediate, device=device)
        self.fc2 = Dense(c.intermediate, d, device=device)
        self.lambda_2 = nn.Parameter(torch.full((d,), c.layer_scale_init, device=device))

    def forward(self, x: torch.Tensor, rel_index: torch.Tensor) -> torch.Tensor:  # (B, N+1, D)
        h = self.ln_before(x)
        q, k, v = (split_heads(f(h), self.heads) for f in (self.q, self.k, self.v))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        scores = scores + self.rel_pos_table[rel_index].permute(2, 0, 1)[None]
        attn = torch.softmax(scores, dim=-1)
        x = x + self.lambda_1 * self.proj(merge_heads(torch.matmul(*promoted(attn, v))))
        h = self.fc2(F.gelu(self.fc1(self.ln_after(x))))
        return x + self.lambda_2 * h


class BeitBackbone(nn.Module):
    def __init__(self, c: BeitConfig, *, device=None):
        super().__init__()
        self.cfg = c
        p = c.patch_size
        self.patch_embed = Conv(3, c.hidden_size, p, stride=p, device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.hidden_size, device=device))
        for i in range(c.layers):
            self.add_module(f"layer{i}", BeitLayer(c, device=device))
        grid = c.image_size // p
        self.register_buffer("rel_index", torch.from_numpy(beit_rel_pos_index(grid, grid)).to(device),
                             persistent=False)

    def forward(self, pixels: torch.Tensor):  # (B, S, S, 3) normalised
        c = self.cfg
        x = self.patch_embed(pixels)
        b, ph, pw, d = x.shape
        x = torch.cat(promoted(self.cls_token.expand(b, 1, d), x.reshape(b, ph * pw, d)), dim=1)
        feats = []
        for i in range(c.layers):
            x = getattr(self, f"layer{i}")(x, self.rel_index)
            if i + 1 in c.out_indices:
                feats.append(x)  # (B, N+1, D), CLS included
        return feats, (ph, pw)


# --- DPT neck ------------------------------------------------------------------
class Reassemble(nn.Module):
    """Readout "project", a 1x1 conv and a rescale per stage."""

    def __init__(self, c: ZoeDepthConfig, *, device=None):
        super().__init__()
        d = c.beit.hidden_size
        self.factors = c.reassemble_factors
        for i, (ch, factor) in enumerate(zip(c.neck_hidden_sizes, c.reassemble_factors)):
            self.add_module(f"readout{i}", Dense(2 * d, d, device=device))
            self.add_module(f"proj{i}", Conv(d, ch, 1, device=device))
            if factor > 1:
                self.add_module(f"resize{i}", ConvTranspose(ch, ch, int(factor), stride=int(factor), device=device))
            elif factor < 1:
                s = int(round(1 / factor))
                self.add_module(f"resize{i}", Conv(ch, ch, 3, stride=s, padding=1, device=device))

    def forward(self, feats, ph: int, pw: int):
        out = []
        for i, hs in enumerate(feats):
            cls, tokens = hs[:, :1], hs[:, 1:]
            b, n, d = tokens.shape
            h = torch.cat([tokens, cls.expand(b, n, d)], dim=-1)
            h = F.gelu(getattr(self, f"readout{i}")(h)).reshape(b, ph, pw, d)
            h = getattr(self, f"proj{i}")(h)
            if self.factors[i] != 1:
                h = getattr(self, f"resize{i}")(h)
            out.append(h)
        return out


class PreActResidual(nn.Module):
    def __init__(self, ch: int, *, device=None):
        super().__init__()
        self.conv1 = Conv(ch, ch, 3, padding=1, device=device)
        self.conv2 = Conv(ch, ch, 3, padding=1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FusionLayer(nn.Module):
    """The first (deepest) fusion layer has no residual input, so no
    ``res1``, as flax creates none."""

    def __init__(self, ch: int, has_residual: bool, *, device=None):
        super().__init__()
        if has_residual:
            self.res1 = PreActResidual(ch, device=device)
        self.res2 = PreActResidual(ch, device=device)
        self.proj = Conv(ch, ch, 1, device=device)

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if residual is not None:
            if residual.shape[1:3] != x.shape[1:3]:
                residual = resize_corners(residual, x.shape[1:3], align_corners=False)
            x = x + self.res1(residual)
        return self.proj(_up2(self.res2(x)))


class Neck(nn.Module):
    def __init__(self, c: ZoeDepthConfig, *, device=None):
        super().__init__()
        self.reassemble = Reassemble(c, device=device)
        fh = c.fusion_hidden_size
        for i, ch in enumerate(c.neck_hidden_sizes):
            self.add_module(f"conv{i}", Conv(ch, fh, 3, padding=1, bias=False, device=device))
        for j in range(len(c.neck_hidden_sizes)):
            self.add_module(f"fusion{j}", FusionLayer(fh, has_residual=j > 0, device=device))

    def forward(self, backbone_feats, ph: int, pw: int):
        stages = self.reassemble(backbone_feats, ph, pw)
        feats = [getattr(self, f"conv{i}")(s) for i, s in enumerate(stages)]
        fused, cur = [], None
        for j, f in enumerate(reversed(feats)):  # deepest first
            layer = getattr(self, f"fusion{j}")
            cur = layer(f) if cur is None else layer(cur, f)
            fused.append(cur)
        return fused, feats[-1]


class RelativeHead(nn.Module):
    def __init__(self, c: ZoeDepthConfig, *, device=None):
        super().__init__()
        fh, nrf = c.fusion_hidden_size, c.num_relative_features
        self.conv1 = Conv(fh, fh // 2, 3, padding=1, device=device)
        self.conv2 = Conv(fh // 2, nrf, 3, padding=1, device=device)
        self.conv3 = Conv(nrf, 1, 1, device=device)

    def forward(self, fused_last: torch.Tensor):
        features = F.relu(self.conv2(_up2(self.conv1(fused_last))))
        return F.relu(self.conv3(features))[..., 0], features


# --- metric bins -----------------------------------------------------------------
def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _log_binom(n: torch.Tensor, k: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    # torch's log(n - k + eps), with the guard the JAX package gives it:
    # maximum() keeps (n + eps) - k == 0 at k == n out of log.
    n = n + eps
    k = k + eps
    return n * torch.log(n) - k * torch.log(k) - (n - k) * torch.log(torch.clamp(n - k, min=eps))


def _log_binomial_softmax(probabilities: torch.Tensor, temperature: torch.Tensor, n_classes: int) -> torch.Tensor:
    """(B, H, W) probabilities -> (B, H, W, K) log-binomial softmax over the
    bins."""
    eps = 1e-4
    p = torch.clamp(probabilities, eps, 1.0)[..., None]
    omp = torch.clamp(1.0 - probabilities, eps, 1.0)[..., None]
    k_idx = torch.arange(n_classes, dtype=torch.float32, device=probabilities.device)
    k_m1 = torch.tensor(float(n_classes - 1), device=probabilities.device)
    y = _log_binom(k_m1, k_idx) + k_idx * torch.log(p) + (k_m1 - k_idx) * torch.log(omp)
    return torch.softmax(y / temperature, dim=-1)


class ConditionalLogBinomial(nn.Module):
    def __init__(self, c: ZoeDepthConfig, in_ch: int, n_classes: int, bottleneck_factor: int = 2, *, device=None):
        super().__init__()
        self.cfg, self.n_classes = c, n_classes
        self.mlp1 = Conv(in_ch, in_ch // bottleneck_factor, 1, device=device)
        self.mlp2 = Conv(in_ch // bottleneck_factor, 4, 1, device=device)

    def forward(self, main_feature: torch.Tensor, condition_feature: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = torch.cat(promoted(main_feature, condition_feature), dim=-1)
        x = _softplus(self.mlp2(F.gelu(self.mlp1(x))))
        prob = x[..., 0:2] + 1e-4
        prob = prob[..., 0] / (prob[..., 0] + prob[..., 1])
        temp = x[..., 2:4] + 1e-4
        temp = temp[..., 0] / (temp[..., 0] + temp[..., 1])
        temp = (c.max_temp - c.min_temp) * temp + c.min_temp
        return _log_binomial_softmax(prob, temp[..., None], self.n_classes)


class SeedBinRegressor(nn.Module):
    def __init__(self, c: ZoeDepthConfig, in_ch: int, n_bins: int, mlp_dim: int, min_depth: float,
                 max_depth: float, *, device=None):
        super().__init__()
        self.normed = c.bin_centers_type == "normed"
        self.min_depth, self.max_depth = min_depth, max_depth
        self.conv1 = Conv(in_ch, mlp_dim, 1, device=device)
        self.conv2 = Conv(mlp_dim, n_bins, 1, device=device)

    def forward(self, x: torch.Tensor):
        h = self.conv2(F.relu(self.conv1(x)))
        if self.normed:
            bc = F.relu(h) + 1e-3
            widths_normed = bc / bc.sum(dim=-1, keepdim=True)
            widths = F.pad((self.max_depth - self.min_depth) * widths_normed, (1, 0), value=self.min_depth)
            edges = torch.cumsum(widths, dim=-1)
            return widths_normed, 0.5 * (edges[..., :-1] + edges[..., 1:])
        bc = _softplus(h)
        return bc, bc


class AttractorLayer(nn.Module):
    """Normed (bounded) or unnormed (softplus) attractors. As upstream (and
    JAX), the attraction uses the function defaults alpha = 300, gamma = 2,
    not the config's fields."""

    def __init__(self, c: ZoeDepthConfig, n_attractors: int, min_depth: float, max_depth: float, *, device=None):
        super().__init__()
        self.normed, self.mean = c.bin_centers_type == "normed", c.attractor_kind == "mean"
        self.n_attractors, self.min_depth, self.max_depth = n_attractors, min_depth, max_depth
        e = c.bin_embedding_dim
        self.conv1 = Conv(e, e, 1, device=device)
        self.conv2 = Conv(e, 2 * n_attractors if self.normed else n_attractors, 1, device=device)

    def forward(self, x: torch.Tensor, prev_bin: torch.Tensor, prev_bin_embedding: Optional[torch.Tensor] = None):
        if prev_bin_embedding is not None:
            if prev_bin_embedding.shape[1:3] != x.shape[1:3]:
                prev_bin_embedding = resize_corners(prev_bin_embedding, x.shape[1:3], align_corners=True)
            x = x + prev_bin_embedding
        h = self.conv2(F.relu(self.conv1(x)))
        if self.normed:
            att = (F.relu(h) + 1e-3).reshape(*h.shape[:3], self.n_attractors, 2)[..., 0]
        else:
            att = _softplus(h)
        bin_centers = resize_corners(prev_bin, x.shape[1:3], align_corners=True)
        dx = att[..., :, None] - bin_centers[..., None, :]  # (B, H, W, A, K)
        delta_c = (dx / (1 + 300.0 * dx**2.0)).sum(dim=-2)
        if self.mean:
            delta_c = delta_c / self.n_attractors
        new_centers = bin_centers + delta_c
        if self.normed:
            scaled = (self.max_depth - self.min_depth) * new_centers + self.min_depth
            scaled = torch.clamp(torch.sort(scaled, dim=-1).values, self.min_depth, self.max_depth)
            return new_centers, scaled
        return new_centers, new_centers


class Projector(nn.Module):
    def __init__(self, in_ch: int, out_features: int, mlp_dim: int = 128, *, device=None):
        super().__init__()
        self.conv1 = Conv(in_ch, mlp_dim, 1, device=device)
        self.conv2 = Conv(mlp_dim, out_features, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x)))


def _metric_depth(probs: torch.Tensor, bin_centers: torch.Tensor) -> torch.Tensor:
    centers_up = resize_corners(bin_centers, probs.shape[1:3], align_corners=True)
    return (probs * centers_up).sum(dim=-1)


class MetricHead(nn.Module):
    """One domain (ZoeDepthMetricDepthEstimationHead)."""

    def __init__(self, c: ZoeDepthConfig, n_bins: int, min_depth: float, max_depth: float, *, device=None):
        super().__init__()
        self.normed = c.bin_centers_type == "normed"
        self.min_depth, self.max_depth = min_depth, max_depth
        fh, bf, e = c.fusion_hidden_size, c.bottleneck_features, c.bin_embedding_dim
        self.n_blocks = len(c.num_attractors)
        self.conv2 = Conv(fh, bf, 1, device=device)
        self.seed_bin_regressor = SeedBinRegressor(c, bf, n_bins, 256, min_depth, max_depth, device=device)
        self.seed_projector = Projector(bf, e, device=device)
        for i, a in enumerate(c.num_attractors):
            self.add_module(f"projector{i}", Projector(fh, e, device=device))
            self.add_module(f"attractor{i}", AttractorLayer(c, a, min_depth, max_depth, device=device))
        self.conditional_log_binomial = ConditionalLogBinomial(c, c.num_relative_features + 1 + e, n_bins,
                                                               device=device)

    def forward(self, outconv, bottleneck, feature_blocks, relative_depth):
        x = self.conv2(bottleneck)
        _, seed_centers = self.seed_bin_regressor(x)
        prev_bin = ((seed_centers - self.min_depth) / (self.max_depth - self.min_depth) if self.normed
                    else seed_centers)
        prev_emb = self.seed_projector(x)
        bin_centers = prev_bin
        for i, feature in enumerate(feature_blocks):
            emb = getattr(self, f"projector{i}")(feature)
            prev_bin, bin_centers = getattr(self, f"attractor{i}")(emb, prev_bin, prev_emb)
            prev_emb = emb
        rel = resize_corners(relative_depth[..., None], outconv.shape[1:3], align_corners=True)
        last = torch.cat(promoted(outconv, rel), dim=-1)
        emb_up = resize_corners(prev_emb, last.shape[1:3], align_corners=True)
        return _metric_depth(self.conditional_log_binomial(last, emb_up), bin_centers)


class PatchTransformer(nn.Module):
    """The router's encoder: a 1x1 embedding, a zero CLS slot, sinusoidal
    positions and four post-LN layers (upstream's forward runs four)."""

    def __init__(self, c: ZoeDepthConfig, in_ch: int, *, device=None):
        super().__init__()
        d, inter = c.patch_transformer_hidden, c.patch_transformer_intermediate
        self.d, self.heads = d, c.patch_transformer_heads
        self.embed = Conv(in_ch, d, 1, device=device)
        for i in range(4):
            for name in ("q", "k", "v", "out"):
                self.add_module(f"l{i}_{name}", Dense(d, d, device=device))
            self.add_module(f"l{i}_ln1", LayerNorm(d, device=device))
            self.add_module(f"l{i}_fc1", Dense(d, inter, device=device))
            self.add_module(f"l{i}_fc2", Dense(inter, d, device=device))
            self.add_module(f"l{i}_ln2", LayerNorm(d, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, C)
        d = self.d
        e = self.embed(x)
        b = e.shape[0]
        e = e.reshape(b, -1, d)
        e = torch.cat([torch.zeros((b, 1, d), dtype=e.dtype, device=e.device), e], dim=1)
        n = e.shape[1]
        pos = torch.arange(n, dtype=torch.float32, device=e.device)[:, None]
        idx = torch.arange(0, d, 2, dtype=torch.float32, device=e.device)[None, :]
        div = torch.exp(idx * (-torch.log(torch.tensor(10000.0, device=e.device)) / d))
        e = e + torch.cat([torch.sin(pos * div), torch.cos(pos * div)], dim=1)[None]
        for i in range(4):
            layer = lambda name: getattr(self, f"l{i}_{name}")  # noqa: E731
            q, k, v = (split_heads(layer(name)(e), self.heads) for name in ("q", "k", "v"))
            a = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1]), dim=-1)
            e = layer("ln1")(e + layer("out")(merge_heads(torch.matmul(a, v))))
            e = layer("ln2")(e + layer("fc2")(F.relu(layer("fc1")(e))))
        return e


class MultiMetricHead(nn.Module):
    """NK: a metric head per domain and the patch-transformer router
    (ZoeDepthMultipleMetricDepthEstimationHeads). The projectors are shared
    across domains; every routed attractor layer has 16 attractors, as
    upstream's constructor leaves them (modeling_zoedepth.py:1027-1033)."""

    def __init__(self, c: ZoeDepthConfig, *, device=None):
        super().__init__()
        self.cfg = c
        self.normed = c.bin_centers_type == "normed"
        fh, bf, e, ptd = c.fusion_hidden_size, c.bottleneck_features, c.bin_embedding_dim, c.patch_transformer_hidden
        self.conv2 = Conv(fh, bf, 1, device=device)
        self.patch_transformer = PatchTransformer(c, bf, device=device)
        self.mlp_classifier1 = Dense(ptd, ptd, device=device)
        self.mlp_classifier2 = Dense(ptd, len(c.bin_configurations), device=device)
        self.seed_projector = Projector(bf, e, e // 2, device=device)
        for i in range(len(c.num_attractors)):
            self.add_module(f"projector{i}", Projector(fh, e, e // 2, device=device))
        for name, n_bins, min_d, max_d in c.bin_configurations:
            self.add_module(f"seed_bin_regressor_{name}",
                            SeedBinRegressor(c, bf, n_bins, e // 2, min_d, max_d, device=device))
            for i in range(len(c.num_attractors)):
                self.add_module(f"attractor{i}_{name}", AttractorLayer(c, 16, min_d, max_d, device=device))
            self.add_module(f"conditional_log_binomial_{name}",
                            ConditionalLogBinomial(c, c.num_relative_features + e, n_bins, 4, device=device))

    def forward(self, outconv, bottleneck, feature_blocks, relative_depth):
        c = self.cfg
        x = self.conv2(bottleneck)
        emb = self.patch_transformer(x)[:, 0]
        domain_logits = self.mlp_classifier2(F.relu(self.mlp_classifier1(emb)))
        winner = torch.argmax(torch.softmax(domain_logits, dim=-1), dim=-1)  # (B,): each lane's own vote
        seed_emb = self.seed_projector(x)
        feat_embs = [getattr(self, f"projector{i}")(f) for i, f in enumerate(feature_blocks)]
        outs = []
        for name, _, min_d, max_d in c.bin_configurations:
            _, seed_centers = getattr(self, f"seed_bin_regressor_{name}")(x)
            prev_bin = (seed_centers - min_d) / (max_d - min_d) if self.normed else seed_centers
            prev_emb, bin_centers = seed_emb, prev_bin
            for i, e in enumerate(feat_embs):
                prev_bin, bin_centers = getattr(self, f"attractor{i}_{name}")(e, prev_bin, prev_emb)
                prev_emb = e
            emb_up = resize_corners(prev_emb, outconv.shape[1:3], align_corners=True)
            probs = getattr(self, f"conditional_log_binomial_{name}")(outconv, emb_up)
            outs.append(_metric_depth(probs, bin_centers))
        stacked = torch.stack(outs)  # (domains, B, H, W)
        return stacked[winner, torch.arange(stacked.shape[1], device=winner.device)], domain_logits


class ZoeDepthModule(nn.Module):
    def __init__(self, cfg: ZoeDepthConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.backbone = BeitBackbone(cfg.beit, device=device)
        self.neck = Neck(cfg, device=device)
        self.relative_head = RelativeHead(cfg, device=device)
        if len(cfg.bin_configurations) > 1:
            self.metric_head = MultiMetricHead(cfg, device=device)
        else:
            _, n_bins, min_d, max_d = cfg.bin_configurations[0]
            self.metric_head = MetricHead(cfg, n_bins, min_d, max_d, device=device)

    def forward(self, pixels: torch.Tensor):
        """(B, S, S, 3) normalised pixels -> (metric depth (B, S, S), the
        router's domain logits (B, domains) or None)."""
        feats, (ph, pw) = self.backbone(pixels)
        fused, bottleneck = self.neck(feats, ph, pw)
        relative_depth, rel_features = self.relative_head(fused[-1])
        out = self.metric_head(rel_features, bottleneck, fused, relative_depth)
        return out if isinstance(self.metric_head, MultiMetricHead) else (out, None)


class ZoeDepth:
    """Metric depth with the monocular-depth ``infer_depth`` contract
    (``models/monodepth.py``; reality_policies.py:156-169)."""

    # ZoeDepthImageProcessor's normalisation
    MEAN = (0.5, 0.5, 0.5)
    STD = (0.5, 0.5, 0.5)

    def __init__(self, cfg: ZoeDepthConfig, module: ZoeDepthModule):
        self.cfg = cfg
        self.module = module.eval().requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.module.backbone.cls_token.device

    @classmethod
    def init_random(cls, cfg: Optional[ZoeDepthConfig] = None, seed: int = 0,
                    device: torch.device | str = default_device()) -> "ZoeDepth":
        """Random f32 weights on ``device`` from a seeded generator there,
        with flax's initializers' scales: lecun-normal kernels, zero biases,
        zero bias tables and CLS token, layer scales at ``layer_scale_init``
        (the same seed gives other numbers than JAX's). ``cfg`` defaults to
        ``tiny_test``."""
        cfg = cfg or ZoeDepthConfig.tiny_test()
        module = ZoeDepthModule(cfg, device=device)
        init_random_(module, torch.Generator(device=device).manual_seed(seed),
                     {"rel_pos_table": 0.0, "cls_token": 0.0})
        with torch.no_grad():
            for name, p in module.named_parameters():
                if name.endswith(("lambda_1", "lambda_2")):
                    p.fill_(cfg.beit.layer_scale_init)
        return cls(cfg, module)

    @classmethod
    def from_jax_params(cls, cfg: ZoeDepthConfig, params_np: Mapping[str, Any],
                        device: torch.device | str = default_device()) -> "ZoeDepth":
        """Load a ``vlfm_tpu`` ZoeDepth parameter tree given as numpy
        arrays. Every parameter must be present and every shape must match;
        the one entry a converted checkpoint has and the module never runs
        is left out (``without_unused_residual``)."""
        module = ZoeDepthModule(cfg, device=device)
        load_jax_params_(module, without_unused_residual(params_np))
        return cls(cfg, module)

    @torch.inference_mode()
    def predict(self, pixels: torch.Tensor) -> torch.Tensor:
        """Normalised (B, S, S, 3) -> metric depth (B, S, S)."""
        with exact_f32(pixels.device):
            return self.module(pixels)[0]

    @torch.inference_mode()
    def infer_depth(self, rgb_uint8: torch.Tensor, min_depth: float, max_depth: float) -> torch.Tensor:
        """(B, H, W, 3) uint8 -> (B, H, W) depth normalised to [0, 1] over
        (min_depth, max_depth), the mapping stack's convention: normalise,
        bring to the model's size (half-pixel bilinear), predict, bring back
        to (H, W), clip. The call is a ``vlfm.monodepth`` span."""
        s = self.cfg.beit.image_size
        with span("vlfm.monodepth", frames=rgb_uint8.shape[0]):
            mean = torch.tensor(self.MEAN, device=rgb_uint8.device)
            std = torch.tensor(self.STD, device=rgb_uint8.device)
            x = resize_bilinear((rgb_uint8.to(torch.float32) / 255.0 - mean) / std, s, s)
            metric = resize_bilinear_hw(self.predict(x), rgb_uint8.shape[1], rgb_uint8.shape[2])
            return torch.clamp((metric - min_depth) / (max_depth - min_depth), 0.0, 1.0)


# ---------------------------------------------------------------------------
# HF conversion (ZoeDepthForDepthEstimation layout)
# ---------------------------------------------------------------------------
def without_unused_residual(params_np: Mapping[str, Any]) -> Mapping[str, Any]:
    """``params_np`` without ``neck.fusion0.res1``: HF's first fusion layer
    holds a residual unit it never runs (there is no coarser stage to add),
    so ``convert_hf_zoedepth`` carries it, as JAX's does (flax ignores it),
    and the port's module has no such parameters."""
    neck = params_np.get("neck", {})
    if "res1" not in neck.get("fusion0", {}):
        return params_np
    fusion0 = {k: v for k, v in neck["fusion0"].items() if k != "res1"}
    return {**params_np, "neck": {**neck, "fusion0": fusion0}}


def _conv2(sd, name):
    return {"conv1": conv(sd, f"{name}.conv1"), "conv2": conv(sd, f"{name}.conv2")}


def _clb(sd, name):
    return {"mlp1": conv(sd, f"{name}.mlp.0"), "mlp2": conv(sd, f"{name}.mlp.2")}


def convert_hf_zoedepth(sd: Mapping[str, Any], cfg: ZoeDepthConfig) -> Dict[str, Any]:
    """A HF ZoeDepthForDepthEstimation state dict -> JAX's ZoeDepth tree.
    Biases are taken where the state dict has them; a ConvTranspose2d's
    (in, out, kh, kw) weight is laid out as a conv's, as flax's
    ``transpose_kernel=True`` reads it."""
    bb = "backbone"
    backbone: Dict[str, Any] = {
        "patch_embed": conv(sd, f"{bb}.embeddings.patch_embeddings.projection"),
        "cls_token": leaf(sd[f"{bb}.embeddings.cls_token"]),
    }
    for i in range(cfg.beit.layers):
        pre = f"{bb}.encoder.layer.{i}"
        att = f"{pre}.attention.attention"
        backbone[f"layer{i}"] = {
            "ln_before": norm(sd, f"{pre}.layernorm_before"),
            "q": dense(sd, f"{att}.query", bias=None),
            "k": dense(sd, f"{att}.key", bias=False),
            "v": dense(sd, f"{att}.value", bias=None),
            "rel_pos_table": leaf(sd[f"{att}.relative_position_bias.relative_position_bias_table"]),
            "proj": dense(sd, f"{pre}.attention.output.dense", bias=None),
            "lambda_1": leaf(sd[f"{pre}.lambda_1"]),
            "lambda_2": leaf(sd[f"{pre}.lambda_2"]),
            "ln_after": norm(sd, f"{pre}.layernorm_after"),
            "fc1": dense(sd, f"{pre}.intermediate.dense", bias=None),
            "fc2": dense(sd, f"{pre}.output.dense", bias=None),
        }
    neck: Dict[str, Any] = {"reassemble": {}}
    ra = "neck.reassemble_stage"
    for i in range(4):
        neck["reassemble"][f"readout{i}"] = dense(sd, f"{ra}.readout_projects.{i}.0", bias=None)
        neck["reassemble"][f"proj{i}"] = conv(sd, f"{ra}.layers.{i}.projection")
        if f"{ra}.layers.{i}.resize.weight" in sd:  # a ConvTranspose2d where the factor is above 1
            neck["reassemble"][f"resize{i}"] = conv(sd, f"{ra}.layers.{i}.resize")
        neck[f"conv{i}"] = conv(sd, f"neck.convs.{i}", bias=False)
    for j in range(4):
        pre = f"neck.fusion_stage.layers.{j}"
        neck[f"fusion{j}"] = {
            "proj": conv(sd, f"{pre}.projection"),
            "res1": {"conv1": conv(sd, f"{pre}.residual_layer1.convolution1"),
                     "conv2": conv(sd, f"{pre}.residual_layer1.convolution2")},
            "res2": {"conv1": conv(sd, f"{pre}.residual_layer2.convolution1"),
                     "conv2": conv(sd, f"{pre}.residual_layer2.convolution2")},
        }
    mh: Dict[str, Any] = {"conv2": conv(sd, "metric_head.conv2")}
    mh["seed_projector"] = _conv2(sd, "metric_head.seed_projector")
    for i in range(4):
        mh[f"projector{i}"] = _conv2(sd, f"metric_head.projectors.{i}")
    if len(cfg.bin_configurations) > 1:
        pt: Dict[str, Any] = {"embed": conv(sd, "metric_head.patch_transformer.embedding_convPxP")}
        for i in range(4):
            pre = f"metric_head.patch_transformer.transformer_encoder.{i}"
            for key, name in (("q", "self_attn.query"), ("k", "self_attn.key"), ("v", "self_attn.value"),
                              ("out", "self_attn.out_proj"), ("fc1", "linear1"), ("fc2", "linear2")):
                pt[f"l{i}_{key}"] = dense(sd, f"{pre}.{name}", bias=None)
            pt[f"l{i}_ln1"] = norm(sd, f"{pre}.norm1")
            pt[f"l{i}_ln2"] = norm(sd, f"{pre}.norm2")
        mh["patch_transformer"] = pt
        mh["mlp_classifier1"] = dense(sd, "metric_head.mlp_classifier.linear1", bias=None)
        mh["mlp_classifier2"] = dense(sd, "metric_head.mlp_classifier.linear2", bias=None)
        for name, *_ in cfg.bin_configurations:
            mh[f"seed_bin_regressor_{name}"] = _conv2(sd, f"metric_head.seed_bin_regressors.{name}")
            for i in range(4):
                mh[f"attractor{i}_{name}"] = _conv2(sd, f"metric_head.attractors.{name}.{i}")
            mh[f"conditional_log_binomial_{name}"] = _clb(sd, f"metric_head.conditional_log_binomial.{name}")
    else:
        mh["seed_bin_regressor"] = _conv2(sd, "metric_head.seed_bin_regressor")
        for i in range(4):
            mh[f"attractor{i}"] = _conv2(sd, f"metric_head.attractors.{i}")
        mh["conditional_log_binomial"] = _clb(sd, "metric_head.conditional_log_binomial")
    relative = {f"conv{j}": conv(sd, f"relative_head.conv{j}") for j in (1, 2, 3)}
    return {"backbone": backbone, "neck": neck, "relative_head": relative, "metric_head": mh}
