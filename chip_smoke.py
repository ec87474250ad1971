"""Drive vlfm_tpu_torch's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  0. device: require CUDA, print the card, its power limit and versions,
     turn TF32 off;
  1. build the CUDA kernels from ``vlfm_tpu_torch/csrc`` (nvcc, sm_90a);
  2. LayerNorm kernel (K1) against its plain version at the main path's
     shapes, with CUDA-event timings of both and of ``F.layer_norm``;
  3. attention kernel (K3) against its plain version: every variant at the
     ViT-g shape (32, 16, 257, 88) in bf16, the main path's layout (q, k, v
     as views of the fused qkv projection) at B=32 and at the spin's 12
     views, the CPU tests' ragged shapes in f32 and a 1024-token case, each
     with the kernel body it took; CUDA-event timings of the kernel, the
     plain version and ``scaled_dot_product_attention``, the bound, and the
     replaced design's time (``PARENT_K3_MS``);
  4. tiny BLIP2-ITM: the same weights on the CPU (plain versions) and on
     the card (K1, K3) give the same cosines;
  5. tiny obstacle map: the same spin frames update a small map on the CPU
     and on the card; the grids agree but for cone-edge flips, and the
     frontiers agree;
  6. main path at full width: BLIP2-ITM (EVA ViT-g/14 + Q-Former, random
     bf16 weights) scores a 12-view spin of the synthetic environment; each
     view updates the obstacle map (frontiers) and fuses into the value map;
     the frontiers are scored and the frontier choice and greedy controller
     pick an action. K1's and K3's launches are counted over this run;
  7. value-map check: injected cosines that favour view 7 must make the
     policy pick a frontier inside view 7's field of view;
  8. timings: full-width ITM scoring per 32-image batch, the spin step
     whole and its obstacle-map part alone;
  9. the MBConv chain kernel (K2) against its plain version at the detection
     path's shapes and at the CPU tests' ragged ones, each with the kernel
     body it took, with CUDA-event timings of both and the replaced design's
     time (``PARENT_K2_MS``);
 10. tiny detection pipeline (OWL-ViT -> COCO route -> gated MobileSAM):
     the same weights on the CPU (plain versions) and on the card (K1, K2)
     give the same boxes, scores and validity, and masks within a flip
     bound;
 11. the detection path at full width: OWL-ViT base-32 and MobileSAM
     (TinyViT-5M at 1024 px), random bf16 weights, on 8 spin frames, for a
     COCO target (both routes) and a non-COCO target at threshold 0 (every
     frame detects, so gated SAM runs all its passes); K1 and K2 launches
     are counted over this run; gated masks must match ungated ones;
 12. full-width detection timings: one pipeline call at B=8 and its parts;
 13. the deformable gather kernel (K4) against its plain version at the
     GroundingDINO encoder's shape (B=8, Q = S = 13,294 over four levels)
     in the main path's f32 and in bf16, at the decoder's (Q = 900, grids
     from reference boxes) and at ragged f32 and bf16 shapes, with grids
     over [-1.5, 1.5] and some at +-1e6; CUDA-event timings of the kernel,
     the plain version and the grid_sample formulation, and the bound;
 14. tiny GroundingDINO pipeline (GroundingDINO -> gated MobileSAM): the
     same weights on the CPU and on the card (K4 4 times per detect call)
     give the same boxes, scores, validity and classes, and masks within a
     flip bound;
 15. the GroundingDINO detection path at full width: GroundingDINO
     SwinT-OGC (Swin-T at 800 px, BERT-base, 900 queries, 256 tokens,
     random bf16 weights) as the pipeline's open-vocabulary detector, the
     OWL-ViT COCO route of phase 11, gated MobileSAM, on the 8 spin frames;
     a non-COCO target at the config threshold and at 0, and a COCO
     target; K4 launches 12 times per GroundingDINO detect call;
 16. GroundingDINO timings: one detect call at B=8 (wall, and device time
     under torch.profiler with K4's share) and one pipeline call.

The last two lines of standard output are the kernels' JSON record and the
device JSON line. ``scripts/profile_torch_step.py`` breaks the time of
phases 6, 8 and 12 (and, with ``--gdino``, of phase 16) down by kernel.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from vlfm_tpu_torch.config import VLFMConfig
from vlfm_tpu_torch.kernels.build import load_library
from vlfm_tpu_torch.mapping import obstacle_map as OM
from vlfm_tpu_torch.mapping import value_map as VM
from vlfm_tpu_torch.mapping.grid import GridSpec2D
from vlfm_tpu_torch.models.blip2_itm import BLIP2ITM, BLIP2ITMConfig
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from vlfm_tpu_torch.models.coco_classes import COCO_CLASSES
from vlfm_tpu_torch.models.coco_detector import CocoDetector
from vlfm_tpu_torch.models.grounding_dino import (
    GroundingDinoConfig,
    GroundingDinoDetector,
    GroundingDinoQueryAdapter,
    deformable_attentions,
)
from vlfm_tpu_torch.models.owl_vit import OwlViTDetConfig, OwlViTDetector
from vlfm_tpu_torch.models.precision import cast_for_serving
from vlfm_tpu_torch.models.sam import SAM, SamConfig
from vlfm_tpu_torch.models.tinyvit import chain_launches
from vlfm_tpu_torch.models.tokenizer import WordPieceTokenizer, toy_vocab
from vlfm_tpu_torch.ops.attention import attention, attention_plan, attention_ref, attention_tolerance, qkv_views
from vlfm_tpu_torch.ops.conv_fused import chain_plan, chain_tolerance, mbconv_chain, mbconv_chain_ref
from vlfm_tpu_torch.ops.deform_gather import deform_gather, deform_gather_ref, deform_gather_tolerance
from vlfm_tpu_torch.ops.norms import bf16_tolerance, layer_norm, layer_norm_ref
from vlfm_tpu_torch.ops.resize import resize_bilinear
from vlfm_tpu_torch.parallel.detection_pipeline import DetectionPipeline
from vlfm_tpu_torch.parallel.engine import PerceptionEngine
from vlfm_tpu_torch.policy import acyclic as AC
from vlfm_tpu_torch.policy.itm import TURN_LEFT, decide, fuse_view, update_obstacles
from vlfm_tpu_torch.runner.fake_env import EnvConfig, FakeObjectNavEnv, two_room_plan
from vlfm_tpu_torch.utils.geometry import xyz_yaw_to_tf_matrix

DEV = torch.device("cuda", 0)
TARGET = "chair"
SPIN_VIEWS = 12
HIGH_VIEW = 7
# Published peaks of one H100 SXM at its 700 W limit: HBM bytes/s, and dense
# operations/s by the operands' type (bf16 on the tensor cores, f32 outside
# them). A kernel's bound is the larger of its
# bytes over the first and its operations over the second.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# (rows, D, dtype, eps): ViT-g and the Q-Former query branch at B=32 (the
# timing batch), the ragged widths of the CPU tests, the shapes phase 4
# gives the kernel (ViT-g and query branch at 12 views, text branch at one
# prompt of 32 tokens), and those phase 9 gives it: OWL-ViT vision at 8
# frames (577 tokens before the head, 576 patches after it), OWL-ViT text at
# the 80 COCO prompts and at one prompt of 8 tokens.
LN_CASES = [
    (8224, 1408, torch.bfloat16, 1e-6),
    (1024, 768, torch.bfloat16, 1e-12),
    (7, 96, torch.float32, 1e-6),
    (1, 33, torch.float32, 1e-6),
    (12 * 257, 1408, torch.bfloat16, 1e-6),
    (12 * 32, 768, torch.bfloat16, 1e-12),
    (32, 768, torch.bfloat16, 1e-12),
    (8 * 577, 768, torch.bfloat16, 1e-5),
    (8 * 576, 768, torch.bfloat16, 1e-5),
    (80 * 8, 512, torch.bfloat16, 1e-5),
    (1 * 8, 512, torch.bfloat16, 1e-5),
]
LN_F32_ATOL = 2e-5  # bf16: ops.norms.bf16_tolerance, one bf16 ulp of plain
TINY_COS_ATOL = 1e-3
LAUNCHES_TEXT = 25  # Q-Former text branch: embed_ln + 12 x (self_ln, ffn_text_ln)
LAUNCHES_IMAGE = 110  # ViT-g 39 x 2 + post_ln, Q-Former 1 + 12 x 2 + 6 cross_ln
ATTN_LAUNCHES_IMAGE = 39  # K3 once per ViT-g block; the Q-Former keeps plain attention
ATTN_LAUNCHES_TEXT = 0
ATTN_SHAPE = (32, 16, 257, 88)  # ViT-g at B=32: batch, heads, tokens, head width
ATTN_SPIN_SHAPE = (12, 16, 257, 88)  # ViT-g at the spin's 12 views
# (variant, the TPU kernels it stands for, arguments, K stored transposed)
ATTN_VARIANTS = [
    ("max/probs", "K3a flash_attention_grouped, K3c flash_attention, diag_attn_core grouped",
     dict(clamp=None, normalize="probs"), False),
    ("max/output", "K3b flash_attention_grouped_v2, diag_attn_core grouped norm_after",
     dict(clamp=None, normalize="output"), False),
    ("clamp80/output/bf16-logits", "layers.attention_bf16_softmax",
     dict(clamp=80.0, normalize="output", round_logits=True), False),
    ("clamp60/output, K transposed", "diag_attn3 attn_kt, diag_attn_core max_free, diag_attn_pure pure_kernel",
     dict(clamp=60.0, normalize="output"), True),
    ("clamp60/output/bf16-logits, K transposed", "diag_attn3 attn_phased and attn_kt pexp16",
     dict(clamp=60.0, normalize="output", round_logits=True), True),
]
# The CPU tests' ragged shapes in f32 (two variants each) and 1024 tokens.
ATTN_RAGGED = [
    ((2, 2, 64, 32), torch.float32), ((1, 16, 257, 88), torch.float32), ((2, 4, 130, 16), torch.float32),
    ((2, 4, 1024, 64), torch.bfloat16),
]
# The K3 and K2 designs this version replaced (commit e23db96), timed by
# that commit's chip_smoke.py on one card in one session with this
# version's kernels; printed beside this version's times.
PARENT_CARD = "commit e23db96 on an NVIDIA H100 80GB HBM3, 700 W"
PARENT_K3_MS = {  # (case, shape) -> ms
    ("max/probs, qkv views (the main path)", ATTN_SHAPE): 0.5001,
    ("max/probs", ATTN_SHAPE): 0.4958,
    ("max/output", ATTN_SHAPE): 0.4476,
    ("clamp80/output/bf16-logits", ATTN_SHAPE): 0.3298,
    ("clamp60/output, K transposed", ATTN_SHAPE): 0.8987,
    ("clamp60/output/bf16-logits, K transposed", ATTN_SHAPE): 0.9022,
    ("max/probs", (2, 2, 64, 32)): 0.0342,
    ("clamp60/output, K transposed", (2, 2, 64, 32)): 0.0307,
    ("max/probs", (1, 16, 257, 88)): 0.1937,
    ("clamp60/output, K transposed", (1, 16, 257, 88)): 0.1764,
    ("max/probs", (2, 4, 130, 16)): 0.0597,
    ("clamp60/output, K transposed", (2, 4, 130, 16)): 0.0502,
    ("max/probs", (2, 4, 1024, 64)): 0.1723,
}
PARENT_K2_MS = {  # shape -> ms
    (8, 256, 256, 64): 2.4812, (2, 256, 256, 64): 0.6331, (8, 64, 64, 160): 0.6191, (2, 64, 64, 160): 0.1584,
    (2, 7, 9, 8): 0.0152, (1, 5, 11, 8): 0.0156,
}
TINY_MAP = dict(map_size=256, map_pad=64, width=160, height=120, views=6)
MAP_FLIPS = 1e-3  # cone-edge cells: atan2/cos differ in the last ulp between devices
FRONTIER_ATOL_M = 0.1  # two cells
# (shape NHWC, Ch, Cout, residual and final gelu, dtype): the detection
# path's K2 calls (stage-0 MBConv and the stride-1 merge into stage 3, at
# B=8 ungated and at one gated pass of 2 frames), then the CPU tests' ragged
# shapes.
CHAIN_CASES = [
    ((8, 256, 256, 64), 256, 64, True, torch.bfloat16),
    ((2, 256, 256, 64), 256, 64, True, torch.bfloat16),
    ((8, 64, 64, 160), 320, 320, False, torch.bfloat16),
    ((2, 64, 64, 160), 320, 320, False, torch.bfloat16),
    ((2, 7, 9, 8), 16, 8, True, torch.float32),
    ((1, 5, 11, 8), 16, 16, False, torch.float32),
]
DET_BATCH = 8
COCO_TARGET = "toilet"  # the canonical HM3D goal: a COCO class, so both routes run
OPEN_TARGET = "fireplace"  # not a COCO class
# OWL-ViT K1 launches: one vision pass is pre_ln + 12 x 2 + post_ln +
# merge_ln, one text encoding 12 x 2 + final_ln; a COCO target runs detect
# twice (80 COCO prompts, then the open-vocabulary retry), another target once.
LAUNCHES_DETECT = 27 + 25
TINY_BOX_ATOL = 1e-4
TINY_MASK_FLIPS = 1e-3  # f32: a pixel flips only where its logit is within ~1e-4 of 0
GATED_MASK_FLIPS = 1e-2  # bf16: cuBLAS picks other GEMM tilings at 2 and 8 frames
# GroundingDINO's four levels at 800 px: Swin-T stages 2-4 (strides 8, 16,
# 32) and the extra stride-2 conv, S = 13,294 tokens.
DEFORM_LEVELS = ((100, 100), (50, 50), (25, 25), (13, 13))
# (name, B, Q, nh, dh, levels, P, value dtype, weights dtype, grids from
# reference boxes): the encoder's self-attention (Q = S) in the main path's
# f32 (flax's promotion keeps GroundingDINO's streams f32 under bf16
# weights) and in bf16, the decoder's cross-attention (900 queries, 4-d
# reference boxes), and the CPU tests' ragged shape in f32 and bf16.
DEFORM_CASES = [
    ("encoder, the main path's f32", 8, 13294, 8, 32, DEFORM_LEVELS, 4, torch.float32, torch.float32, False),
    ("encoder, bf16 value and weights", 8, 13294, 8, 32, DEFORM_LEVELS, 4, torch.bfloat16, torch.bfloat16, False),
    ("decoder, the main path's f32", 8, 900, 8, 32, DEFORM_LEVELS, 4, torch.float32, torch.float32, True),
    ("ragged f32", 1, 70, 2, 16, ((7, 9), (4, 5), (2, 3)), 3, torch.float32, torch.float32, False),
    ("ragged bf16", 1, 70, 2, 16, ((7, 9), (4, 5), (2, 3)), 3, torch.bfloat16, torch.float32, False),
]
FAR_SHARE = 0.01  # grids at +-1e6: far off every map
TINY_GDINO_BOX_ATOL = 1e-4
K4_PER_DETECT = deformable_attentions(GroundingDinoConfig())  # 6 encoder + 6 decoder layers


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


# --- phase 0 -----------------------------------------------------------------
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}"
    )
    torch.cuda.set_device(DEV)
    return smi


# --- phase 1 -----------------------------------------------------------------
def phase_build() -> None:
    t0 = time.perf_counter()
    load_library()
    log(f"[build] csrc/*.cu -> sm_90a in {time.perf_counter() - t0:.2f} s")


# --- phase 2 -----------------------------------------------------------------
def _median_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Median device time of one call, from CUDA events around each of
    ``reps`` calls. A spin kernel holds the card first, so the host queues
    all calls (and its Python overhead) before the first one starts and the
    events time the device's work alone."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # ~50 ms of clock cycles
    for a, b in zip(starts, ends):
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in zip(starts, ends)]))


def wall_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median wall time of one call that ends in a device synchronise."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def bound(n_bytes: float, n_ops: float, dtype: torch.dtype) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes
    over HBM's rate and the operations over the peak rate for ``dtype``."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_layer_norm() -> dict:
    gen = torch.Generator(device=DEV).manual_seed(0)
    rows_out = []
    for rows, d, dt, eps in LN_CASES:
        x = (torch.randn(rows, d, generator=gen, device=DEV) * 2.0 + 0.5).to(dt)
        scale = 1.0 + 0.1 * torch.randn(d, generator=gen, device=DEV)
        bias = 0.1 * torch.randn(d, generator=gen, device=DEV)
        got = layer_norm(x, scale, bias, eps)
        torch.cuda.synchronize()
        want = layer_norm_ref(x, scale, bias, eps)
        check(got.shape == want.shape and got.dtype == want.dtype, f"LN {rows}x{d} shape/dtype")
        err = (got.float() - want.float()).abs()
        max_abs = float(err.max())
        if dt == torch.float32:
            ok = max_abs <= LN_F32_ATOL
            tol = f"max abs <= {LN_F32_ATOL}"
        else:
            ratio = float((err / bf16_tolerance(want)).max())
            ok = ratio <= 1.0
            tol = f"each <= 1 bf16 ulp of plain, floor 1e-6 (max {ratio:.2f} of that)"
        ms = _median_ms(lambda: layer_norm(x, scale, bias, eps))
        plain_ms = _median_ms(lambda: layer_norm_ref(x, scale, bias, eps))
        sc, bi = scale.to(dt), bias.to(dt)
        library_ms = _median_ms(lambda: F.layer_norm(x, (d,), sc, bi, eps))
        # x read once and y written once, plus the f32 scale and bias; about
        # 9 f32 operations per element (two sums, centre, square, scale, shift)
        bound_ms, bound_by = bound(2 * x.numel() * x.element_size() + 8 * d, 9 * x.numel(), torch.float32)
        log(
            f"[layer_norm] {rows}x{d} {str(dt).split('.')[-1]} eps={eps:g}: max_abs_err={max_abs:.3e} "
            f"{tol} {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"F.layer_norm {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})"
        )
        check(ok, f"layer_norm {rows}x{d} {dt} disagrees with its plain version")
        rows_out.append(dict(shape=(rows, d), max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by))
    return rows_out[0]  # the ViT-g serving shape stands for the kernel


# --- phase 3 -----------------------------------------------------------------
def attention_inputs(shape, dtype, gen, layout: str = ""):
    """Seeded q, k, v on the card. ``layout``: "" contiguous (B, H, L, D);
    "kt" K stored as (B, H, D, L); "qkv" views of one fused (B, L, 3HD)
    projection, as the ViT passes them."""
    b, h, l, d = shape
    if layout == "qkv":
        return qkv_views(torch.randn(b, l, 3 * h * d, generator=gen, device=DEV).to(dtype), h)
    q, k, v = (torch.randn(b, h, l, d, generator=gen, device=DEV).to(dtype) for _ in range(3))
    if layout == "kt":
        k = k.transpose(-1, -2).contiguous().transpose(-1, -2)
    return q, k, v


def attention_bound(shape, dtype) -> tuple[float, str]:
    """q, k and v read once and o written once; 2 L^2 D operations for each
    of the two products, per head."""
    b, h, l, d = shape
    return bound(4 * b * h * l * d * torch.finfo(dtype).bits // 8, 4 * b * h * l * l * d, dtype)


def phase_attention() -> dict:
    gen = torch.Generator(device=DEV).manual_seed(0)
    cases = [("max/probs, qkv views (the main path)", ATTN_SHAPE, torch.bfloat16, ATTN_VARIANTS[0][2], "qkv"),
             ("max/probs, qkv views (the spin's 12 views)", ATTN_SPIN_SHAPE, torch.bfloat16, ATTN_VARIANTS[0][2],
              "qkv")]
    cases += [(name, ATTN_SHAPE, torch.bfloat16, kw, "kt" if kt else "") for name, _, kw, kt in ATTN_VARIANTS]
    for shape, dt in ATTN_RAGGED:
        variants = ATTN_VARIANTS[:1] if dt == torch.bfloat16 else (ATTN_VARIANTS[0], ATTN_VARIANTS[3])
        cases += [(name, shape, dt, kw, "kt" if kt else "") for name, _, kw, kt in variants]
    rows_out = []
    for name, shape, dt, kw, layout in cases:
        q, k, v = attention_inputs(shape, dt, gen, layout)
        got = attention(q, k, v, **kw)
        torch.cuda.synchronize()
        body = attention_plan(q, k, v, got).describe()
        want = attention_ref(q, k, v, **kw)
        check(got.shape == want.shape and got.dtype == want.dtype, f"K3 {name} {shape} shape/dtype")
        err = (got.float() - want.float()).abs()
        ratio = float((err / attention_tolerance(want, kw.get("round_logits", False))).max())
        max_abs = float(err.max())
        ms = _median_ms(lambda: attention(q, k, v, **kw))
        plain_ms = _median_ms(lambda: attention_ref(q, k, v, **kw))
        library_ms = _median_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        bound_ms, bound_by = attention_bound(shape, dt)
        tol = "2e-5" if dt == torch.float32 else "2e-2" if kw.get("round_logits") else "2 bf16 ulps of plain, floor 4e-3"
        parent = PARENT_K3_MS.get((name, shape))
        log(
            f"[attention] {shape} {str(dt).split('.')[-1]} {name} ({body}): max_abs_err={max_abs:.3e}, "
            f"{ratio:.2f} of the tolerance ({tol}) "
            f"{'ok' if ratio <= 1 else 'FAIL'}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})"
            + (f", the parent's kernel {parent:.4f} ms ({PARENT_CARD})" if parent else "")
        )
        check(ratio <= 1.0, f"attention {name} {shape} {dt} disagrees with its plain version")
        rows_out.append(dict(name=name, shape=shape, max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by))
        del q, k, v, got, want, err
    return rows_out[0]  # the main path's layout and variant at the ViT-g shape stands for the kernel


# --- phase 4 -----------------------------------------------------------------
def phase_tiny_model() -> None:
    cfg = dataclasses.replace(BLIP2ITMConfig.tiny(), compute_dtype=torch.float32)
    itm_cpu = BLIP2ITM.init_random(cfg, seed=0, device="cpu")
    itm_gpu = BLIP2ITM(cfg, copy.deepcopy(itm_cpu.module).to(DEV))
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.uniform(0, 1, (3, 56, 56, 3)).astype(np.float32))
    tok = WordPieceTokenizer(toy_vocab(), max_len=16)
    ids, mask = tok.encode_batch(["a red chair", "a bed"])
    want = itm_cpu.cosine(imgs, ids, mask)
    ln0, k30 = layer_norm.launches, attention.launches
    got = itm_gpu.cosine(imgs.to(DEV), ids.to(DEV), mask.to(DEV)).cpu()
    err = float((got - want).abs().max())
    log(
        f"[tiny] cosines gpu vs cpu: max_abs_err={err:.3e} (tol {TINY_COS_ATOL}), "
        f"K1 {layer_norm.launches - ln0}, K3 {attention.launches - k30} launches"
    )
    check(err <= TINY_COS_ATOL, "tiny BLIP2-ITM cosines differ between card and CPU")
    check(layer_norm.launches > ln0, "tiny model on the card did not launch K1")
    check(attention.launches - k30 == cfg.vit.depth, "tiny model on the card: one K3 launch per ViT block")


# --- phase 5 -----------------------------------------------------------------
def spin_views(n: int, width: int = 640, height: int = 480) -> list[dict]:
    env = FakeObjectNavEnv(two_room_plan(seed=0), EnvConfig(width=width, height=height))
    views = [env.reset()]
    views += [env.step(TURN_LEFT) for _ in range(n - 1)]
    return views


def view_inputs(views, cfg: VLFMConfig, device) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """(camera-to-episodic transform, normalized depth) of each view."""
    out = []
    for o in views:
        xyz = torch.tensor([o["robot_xy"][0], o["robot_xy"][1], cfg.camera.camera_height],
                           dtype=torch.float32, device=device)
        tf = xyz_yaw_to_tf_matrix(xyz, torch.tensor(o["heading"], dtype=torch.float32, device=device))
        out.append((tf, torch.from_numpy(o["depth"].astype(np.float32)).to(device)))
    return out


def spin_obstacles(inputs, spec: GridSpec2D, cfg: VLFMConfig, device) -> OM.ObstacleMapState:
    """The obstacle-map half of the spin: one update per view."""
    state = OM.create(spec, cfg.max_frontiers, device=device)
    for steps, (tf, depth) in enumerate(inputs):
        state = update_obstacles(state, spec, cfg, depth, tf, steps)
    return state


def spin_maps(inputs, cosines: torch.Tensor, spec: GridSpec2D, cfg: VLFMConfig):
    """Per view, the obstacle-map update and the value-map fusion, as the
    policy step runs them (vlfm_tpu/policy/itm.py:124-156)."""
    obstacle = OM.create(spec, cfg.max_frontiers, device=DEV)
    value = VM.create(spec, cfg.value_channels, device=DEV)
    for steps, ((tf, depth), cos) in enumerate(zip(inputs, cosines.to(DEV))):
        obstacle = update_obstacles(obstacle, spec, cfg, depth, tf, steps)
        fuse_view(value, spec, cfg, cos, depth, tf)
    return obstacle, value


def spin_decision(views, obstacle: OM.ObstacleMapState, value: VM.ValueMapState, spec: GridSpec2D):
    """Score the obstacle map's frontiers on the value map and choose one."""
    last = views[-1]
    return decide(
        value, spec, obstacle,
        torch.tensor(last["robot_xy"], dtype=torch.float32, device=DEV),
        torch.tensor(last["heading"], dtype=torch.float32, device=DEV),
        torch.zeros(2, device=DEV), torch.tensor(-math.inf, device=DEV),
        AC.create(device=DEV),
    )


def phase_tiny_obstacle_map() -> None:
    t = TINY_MAP
    cfg = dataclasses.replace(VLFMConfig(), map_size=t["map_size"], map_pad=t["map_pad"],
                              camera=dataclasses.replace(VLFMConfig().camera, width=t["width"], height=t["height"]))
    spec = GridSpec2D(cfg.map_size, cfg.pixels_per_meter, cfg.map_pad)
    views = spin_views(t["views"], t["width"], t["height"])
    want = spin_obstacles(view_inputs(views, cfg, "cpu"), spec, cfg, "cpu")
    got = spin_obstacles(view_inputs(views, cfg, DEV), spec, cfg, DEV)
    torch.cuda.synchronize()
    cells = t["views"] * 224 * 224  # the fog-of-war windows the spin updated
    flips = {n: int((getattr(got, n).cpu() != getattr(want, n)).sum()) for n in ("obstacles", "navigable", "explored")}
    valid_eq = torch.equal(got.frontiers_valid.cpu(), want.frontiers_valid)
    fr_err = float((got.frontiers_xy.cpu() - want.frontiers_xy).abs().max())
    log(
        f"[tiny-map] {t['map_size']}+2x{t['map_pad']} px map, {t['views']} views at {t['width']}x{t['height']}: "
        f"card vs CPU flips {flips} (tol {MAP_FLIPS} of {cells} cells), {int(want.frontiers_valid.sum())} "
        f"frontiers, validity equal {valid_eq}, max position error {fr_err:.3e} m (tol {FRONTIER_ATOL_M})"
    )
    check(all(f <= MAP_FLIPS * cells for f in flips.values()), "tiny obstacle map differs between card and CPU")
    check(valid_eq and fr_err <= FRONTIER_ATOL_M, "tiny obstacle map frontiers differ between card and CPU")
    check(bool(want.frontiers_valid.any()), "tiny obstacle map found no frontier")


# --- phase 6 -----------------------------------------------------------------
def phase_main_path(views, engine: PerceptionEngine, spec, cfg) -> dict:
    rgb = torch.from_numpy(np.stack([o["rgb"] for o in views])).to(DEV)
    inputs = view_inputs(views, cfg, DEV)
    layer_norm.launches = 0
    attention.launches = 0
    t0 = time.perf_counter()
    engine.text_features(TARGET)
    torch.cuda.synchronize()
    text = dict(layer_norm=layer_norm.launches, attention=attention.launches)
    cosines = engine.score(rgb, TARGET)
    torch.cuda.synchronize()
    image = dict(layer_norm=layer_norm.launches - text["layer_norm"], attention=attention.launches - text["attention"])
    obstacle, value = spin_maps(inputs, cosines, spec, cfg)
    dec = spin_decision(views, obstacle, value, spec)
    action = int(dec.action)
    wall = time.perf_counter() - t0
    launches = dict(layer_norm=layer_norm.launches, attention=attention.launches)
    log(
        f"[main] K1 launches: encode_texts {text['layer_norm']} (expect {LAUNCHES_TEXT}), "
        f"cosine_cached_text {image['layer_norm']} (expect {LAUNCHES_IMAGE}); K3 launches: encode_texts "
        f"{text['attention']} (expect {ATTN_LAUNCHES_TEXT}), cosine_cached_text {image['attention']} "
        f"(expect {ATTN_LAUNCHES_IMAGE})"
    )
    check(text["layer_norm"] == LAUNCHES_TEXT, "encode_texts K1 launch count")
    check(image["layer_norm"] == LAUNCHES_IMAGE, "cosine_cached_text K1 launch count")
    check(text["attention"] == ATTN_LAUNCHES_TEXT, "encode_texts K3 launch count")
    check(image["attention"] == ATTN_LAUNCHES_IMAGE, "cosine_cached_text K3 launch count")

    c = cosines.float().cpu()
    log(f"[main] cosines {tuple(c.shape)}: {[round(v, 5) for v in c[:, 0].tolist()]}")
    check(c.shape == (len(views), cfg.value_channels), "cosine shape")
    check(bool(torch.isfinite(c).all()), "cosines finite")
    check(bool(torch.isfinite(value.values).all() and torch.isfinite(value.conf).all()), "value map finite")
    valid = obstacle.frontiers_valid.cpu()
    fxy = obstacle.frontiers_xy.cpu()[valid]
    log(
        f"[main] obstacle map: {int(obstacle.obstacles.sum())} obstacle cells, {int(obstacle.explored.sum())} "
        f"explored, {int(valid.sum())} frontiers {[tuple(round(v, 2) for v in xy) for xy in fxy.tolist()]}, "
        f"overflow {bool(obstacle.frontier_overflow)}"
    )
    check(bool(valid.any()), "the obstacle map has no valid frontier")
    log(
        f"[main] chose frontier {[round(v, 3) for v in dec.choice.frontier.tolist()]}, value "
        f"{float(dec.choice.value):.5f}, rho {float(dec.rho):.3f} theta {float(dec.theta):.3f}, "
        f"action {action}; wall {wall:.2f} s incl. first calls"
    )
    check(action in (0, 1, 2, 3), "action is a habitat action")
    check(bool(dec.choice.any_valid), "the decision found no frontier")
    check(all(bool(torch.isfinite(t).all()) for t in (dec.choice.frontier, dec.choice.value, dec.rho, dec.theta)),
          "decision finite")
    check(bool(torch.isfinite(dec.waypoint_values[valid.to(DEV)]).all()), "frontier values finite")
    return launches


# --- phase 7 -----------------------------------------------------------------
def phase_value_map_check(views, spec, cfg) -> None:
    cos = torch.full((len(views), cfg.value_channels), 0.1)
    cos[HIGH_VIEW] = 0.9
    obstacle, value = spin_maps(view_inputs(views, cfg, DEV), cos, spec, cfg)
    dec = spin_decision(views, obstacle, value, spec)
    robot = views[-1]["robot_xy"]
    fx, fy = dec.choice.frontier.tolist()
    off = math.remainder(math.atan2(fy - robot[1], fx - robot[0]) - views[HIGH_VIEW]["heading"], 2 * math.pi)
    log(
        f"[value-map] injected high cosine at view {HIGH_VIEW}: chose frontier ({fx:.2f}, {fy:.2f}) at "
        f"{math.degrees(off):.1f} deg from that view's heading, value {float(dec.choice.value):.4f}"
    )
    check(abs(off) <= cfg.camera.hfov / 2, "the chosen frontier is not in the high-value view's field of view")


# --- phase 8 -----------------------------------------------------------------
def itm_batch_ms(views, engine: PerceptionEngine, batch: int = 32) -> float:
    """Median wall time of one full-width ITM scoring call on ``batch``
    preprocessed spin frames, each call ending in a device synchronise."""
    rgb = np.stack([views[i % len(views)]["rgb"] for i in range(batch)])
    itm = engine.itm
    imgs = itm.preprocess(torch.from_numpy(rgb).to(itm.device))
    feats = engine.text_features(TARGET)
    return wall_ms(lambda: itm.cosine_cached_text(imgs, feats), reps=10, warmup=3)


def spin_step_fns(views, engine: PerceptionEngine, spec, cfg):
    """The 12-view spin step whole (ITM scoring, both maps per view, the
    decision) and its obstacle-map part alone, on frames already on the
    card."""
    rgb = torch.from_numpy(np.stack([o["rgb"] for o in views])).to(DEV)
    inputs = view_inputs(views, cfg, DEV)

    def step():
        obstacle, value = spin_maps(inputs, engine.score(rgb, TARGET), spec, cfg)
        return spin_decision(views, obstacle, value, spec)

    return step, lambda: spin_obstacles(inputs, spec, cfg, DEV)


def phase_timing(views, engine: PerceptionEngine, spec, cfg, smi: str) -> None:
    ms = itm_batch_ms(views, engine)
    log(
        f"[itm] full-width BLIP2-ITM B=32: {ms:.2f} ms/batch median of 10 "
        f"({32 / ms * 1e3:.1f} images/s) on {smi}"
    )
    step, obstacles = spin_step_fns(views, engine, spec, cfg)
    step_ms = wall_ms(step, reps=5, warmup=1)
    om_ms = wall_ms(obstacles, reps=5, warmup=1)
    log(
        f"[step] 12-view spin step: {step_ms:.2f} ms whole, of which the 12 obstacle-map updates "
        f"{om_ms:.2f} ms (wall, median of 5) on {smi}"
    )


# --- phase 9 -----------------------------------------------------------------
def chain_inputs(shape, ch, cout, dtype, gen):
    """x and lecun-scaled chain weights in the JAX layouts, biases f32."""
    cin = shape[-1]

    def rnd(*s, scale=1.0):
        return torch.randn(*s, generator=gen, device=DEV) * scale

    x = rnd(*shape).to(dtype)
    w = (rnd(cin, ch, scale=cin**-0.5).to(dtype), 0.1 * rnd(ch), rnd(3, 3, ch, scale=1 / 3).to(dtype),
         0.1 * rnd(ch), rnd(ch, cout, scale=ch**-0.5).to(dtype), 0.1 * rnd(cout))
    return x, w


def phase_mbconv_chain() -> dict:
    gen = torch.Generator(device=DEV).manual_seed(0)
    rows_out = []
    for shape, ch, cout, res, dt in CHAIN_CASES:
        x, w = chain_inputs(shape, ch, cout, dt, gen)
        got = mbconv_chain(x, *w, residual=res, final_gelu=res)
        torch.cuda.synchronize()
        want = mbconv_chain_ref(x, *w, residual=res, final_gelu=res)
        check(got.shape == want.shape and got.dtype == want.dtype, f"K2 {shape} shape/dtype")
        err = (got.float() - want.float()).abs()
        ratio = float((err / chain_tolerance(want)).max())
        max_abs = float(err.max())
        ms = _median_ms(lambda: mbconv_chain(x, *w, residual=res, final_gelu=res))
        plain_ms = _median_ms(lambda: mbconv_chain_ref(x, *w, residual=res, final_gelu=res))
        # x read and y written once (the weights are small); the two 1x1
        # products and the 3x3 depthwise taps, 2 operations per multiply-add
        pixels = x.numel() // x.shape[-1]
        n_bytes = (x.numel() + pixels * cout) * x.element_size() + sum(t.numel() * t.element_size() for t in w)
        bound_ms, bound_by = bound(n_bytes, 2 * pixels * (shape[-1] * ch + 9 * ch + ch * cout), dt)
        tol = "1e-5 relative" if dt == torch.float32 else "2 bf16 ulps of plain, floor 4e-3"
        parent = PARENT_K2_MS.get(shape)
        log(
            f"[mbconv_chain] {shape}->{ch}->{cout} {str(dt).split('.')[-1]} res={res} "
            f"({chain_plan(x, *w[:5], got).body}): max_abs_err={max_abs:.3e}, {ratio:.2f} of the "
            f"tolerance ({tol}), {float((err > 0).float().mean()):.2e} of elements differ "
            f"{'ok' if ratio <= 1 else 'FAIL'}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}); no single PyTorch call computes the chain"
            + (f"; the parent's kernel {parent:.4f} ms ({PARENT_CARD})" if parent else "")
        )
        check(ratio <= 1.0, f"mbconv_chain {shape} {dt} disagrees with its plain version")
        rows_out.append(dict(shape=shape, max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
        del x, w, got, want, err
    return rows_out[0]  # stage 0 at B=8 stands for the kernel


# --- phase 10 ----------------------------------------------------------------
def encode_queries(names):
    """Prompt ids for OWL-ViT: the toy WordPiece vocabulary, 8 tokens."""
    return WordPieceTokenizer(toy_vocab(), max_len=8).encode_batch(list(names))


def make_pipeline(det, sam, cfg: VLFMConfig, capacity, non_coco_threshold=None) -> DetectionPipeline:
    k = cfg.max_detections_per_frame
    coco = CocoDetector(det, encode_queries, conf_threshold=cfg.coco_threshold, max_detections=k)
    return DetectionPipeline(
        det, sam, encode_queries, coco_detector=coco, coco_threshold=cfg.coco_threshold,
        non_coco_threshold=cfg.non_coco_threshold if non_coco_threshold is None else non_coco_threshold,
        max_detections=k, sam_frame_capacity=capacity,
    )


def phase_tiny_pipeline() -> None:
    cfg = VLFMConfig()
    det_cpu = OwlViTDetector.init_random(OwlViTDetConfig.tiny(), seed=0, device="cpu")
    sam_cpu = SAM.init_random(SamConfig.tiny_mobile_sam(), seed=0, device="cpu")
    det_gpu = OwlViTDetector(det_cpu.cfg, copy.deepcopy(det_cpu.module).to(DEV))
    sam_gpu = SAM(sam_cpu.cfg, copy.deepcopy(sam_cpu.module).to(DEV))
    rgb = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (5, 48, 64, 3), dtype=np.uint8))
    for target, thr in ((COCO_TARGET, None), (OPEN_TARGET, 0.0)):
        want = make_pipeline(det_cpu, sam_cpu, cfg, 2, thr)(rgb, target)
        ln0, k20 = layer_norm.launches, mbconv_chain.launches
        got = make_pipeline(det_gpu, sam_gpu, cfg, 2, thr)(rgb.to(DEV), target)
        torch.cuda.synchronize()
        (gm, gv, (gx, gs, gc)), (wm, wv, (wx, ws, wc)) = got, want
        box_err = max(float((gx.cpu() - wx).abs().max()), float((gs.cpu() - ws).abs().max()))
        flips = float((gm.cpu() != wm).float().mean())
        log(
            f"[tiny-det] {target}: card vs CPU boxes/scores max_abs_err={box_err:.3e} (tol {TINY_BOX_ATOL}), "
            f"valid equal {bool(torch.equal(gv.cpu(), wv))}, cls equal {bool(torch.equal(gc.cpu(), wc))}, "
            f"{int(wv.sum())} detections, mask flips {flips:.2e} (tol {TINY_MASK_FLIPS}); "
            f"K1 {layer_norm.launches - ln0}, K2 {mbconv_chain.launches - k20} launches"
        )
        check(box_err <= TINY_BOX_ATOL, f"tiny pipeline boxes differ between card and CPU ({target})")
        check(torch.equal(gv.cpu(), wv) and torch.equal(gc.cpu(), wc), f"tiny pipeline valid/cls ({target})")
        check(flips <= TINY_MASK_FLIPS, f"tiny pipeline masks differ between card and CPU ({target})")
        check(layer_norm.launches > ln0, "tiny pipeline on the card did not launch K1")
        if bool(wv.any()):
            check(mbconv_chain.launches > k20, "tiny pipeline on the card did not launch K2")


# --- phase 11 ----------------------------------------------------------------
def build_detection_path():
    """The full-width detection configuration: OWL-ViT base-32 and MobileSAM
    with random bf16 weights (f32 norms), the VLFMConfig thresholds, SAM
    gated at max(2, B // 4) frames, and 8 frames of the spin."""
    cfg = dataclasses.replace(VLFMConfig(), sam_frame_capacity=max(2, DET_BATCH // 4))
    det = OwlViTDetector.init_random(OwlViTDetConfig(compute_dtype=torch.bfloat16), seed=0, device=DEV)
    sam = SAM.init_random(SamConfig.mobile_sam(), seed=0, device=DEV)
    cast_for_serving(det.module)
    cast_for_serving(sam.module)
    rgb = torch.from_numpy(np.stack([o["rgb"] for o in spin_views(DET_BATCH)])).to(DEV)
    return cfg, det, sam, rgb


def check_detections(name, out, b, h, w, k, n_classes=80) -> int:
    """Shapes, finite boxes in [0, 1], masks only on valid slots, and class
    ids below ``n_classes`` (the COCO classes, or a caption's phrases).
    Returns the number of frames with a valid detection."""
    masks, valid, (xyxy, scores, cls) = out
    check(masks.shape == (b, k, h, w) and masks.dtype == torch.bool, f"{name}: mask shape")
    check(valid.shape == (b, k) and xyxy.shape == (b, k, 4), f"{name}: box shape")
    check(bool(torch.isfinite(xyxy).all() and torch.isfinite(scores.float()).all()), f"{name}: finite boxes")
    check(bool(((xyxy >= 0) & (xyxy <= 1)).all()), f"{name}: boxes in [0, 1]")
    check(not bool(masks[~valid].any()), f"{name}: masks only where valid")
    check(bool(((cls >= 0) & (cls < n_classes)).all()), f"{name}: class ids")
    return int(valid.any(dim=1).sum())


def phase_detection_path(cfg, det, sam, rgb) -> dict:
    b, h, w = rgb.shape[:3]
    k, cap = cfg.max_detections_per_frame, cfg.sam_frame_capacity
    per_pass = chain_launches(sam.cfg.tinyvit)
    pipe_coco = make_pipeline(det, sam, cfg, cap)
    pipe_open = make_pipeline(det, sam, cfg, cap, non_coco_threshold=0.0)
    layer_norm.launches = 0
    mbconv_chain.launches = 0
    t0 = time.perf_counter()
    out_coco = pipe_coco(rgb, COCO_TARGET)
    torch.cuda.synchronize()
    ln_coco, k2_coco = layer_norm.launches, mbconv_chain.launches
    out_open = pipe_open(rgb, OPEN_TARGET)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(layer_norm=layer_norm.launches, mbconv_chain=mbconv_chain.launches)
    ln_open, k2_open = launches["layer_norm"] - ln_coco, launches["mbconv_chain"] - k2_coco

    frames_coco = check_detections(COCO_TARGET, out_coco, b, h, w, k)
    frames_open = check_detections(OPEN_TARGET, out_open, b, h, w, k)
    passes_coco, passes_open = -(-frames_coco // cap), -(-frames_open // cap)
    log(
        f"[detect] {COCO_TARGET}: {int(out_coco[1].sum())} detections on {frames_coco} of {b} frames, "
        f"{passes_coco} SAM passes; K1 {ln_coco} (expect {2 * LAUNCHES_DETECT}), "
        f"K2 {k2_coco} (expect {per_pass * passes_coco})"
    )
    log(
        f"[detect] {OPEN_TARGET} at threshold 0: {int(out_open[1].sum())} detections on {frames_open} of "
        f"{b} frames, {passes_open} SAM passes; K1 {ln_open} (expect {LAUNCHES_DETECT}), "
        f"K2 {k2_open} (expect {per_pass * passes_open}); wall {wall:.2f} s incl. first calls"
    )
    check(ln_coco == 2 * LAUNCHES_DETECT and ln_open == LAUNCHES_DETECT, "detection path K1 launch count")
    check(k2_coco == per_pass * passes_coco and k2_open == per_pass * passes_open, "K2 launches per SAM pass")
    check(frames_open == b and passes_open == -(-b // cap), "threshold 0 must put detections on every frame")

    ungated = make_pipeline(det, sam, cfg, None, non_coco_threshold=0.0)(rgb, OPEN_TARGET)
    gm, gv, _ = out_open
    um, uv, _ = ungated
    check(torch.equal(gv, uv), "gated and ungated validity differ")
    flips = float((gm != um)[gv].float().mean())
    log(f"[detect] gated (capacity {cap}) against ungated masks on valid slots: {flips:.2e} of pixels flip "
        f"(tol {GATED_MASK_FLIPS})")
    check(flips <= GATED_MASK_FLIPS, "gated masks differ from ungated masks")
    return launches


# --- phase 12 ----------------------------------------------------------------
def phase_detection_timing(cfg, det, sam, rgb, smi: str) -> None:
    pipe = make_pipeline(det, sam, cfg, cfg.sam_frame_capacity)
    s = sam.cfg.vision.image_size
    sam_imgs = resize_bilinear(rgb.to(torch.float32), s, s)
    out = pipe(rgb, COCO_TARGET)
    boxes = out[2][0]
    ids, mask = pipe._queries(COCO_TARGET)
    coco_ids, coco_mask = pipe.coco_detector._coco_queries()
    imgs = det.preprocess(rgb)
    emb = sam.encode(sam_imgs)
    parts = {
        f"pipeline call ({COCO_TARGET}, both routes, gated SAM)": lambda: pipe(rgb, COCO_TARGET),
        "OWL-ViT detect, 80 COCO prompts": lambda: det.detect(imgs, coco_ids, coco_mask),
        "OWL-ViT detect, 1 prompt": lambda: det.detect(imgs, ids, mask),
        f"SAM encode, {DET_BATCH} frames": lambda: sam.encode(sam_imgs),
        "SAM encode, 2 frames (one gated pass)": lambda: sam.encode(sam_imgs[:2]),
        f"SAM decode, {DET_BATCH} frames x {boxes.shape[1]} boxes": lambda: sam.decode(emb, boxes),
    }
    for name, fn in parts.items():
        ms = wall_ms(fn)
        log(f"[det-time] B={DET_BATCH} {name}: {ms:.2f} ms (wall, median of 10) on {smi}")


# --- phase 13 ----------------------------------------------------------------
def deform_inputs(b, q, nh, dh, levels, npts, vdtype, wdtype, from_boxes, gen):
    """Seeded value, grids and softmaxed weights on the card. Grids spread
    over [-1.5, 1.5] (the encoder: reference points plus offsets), or come
    from reference boxes as the decoder makes them; FAR_SHARE of them sit at
    +-1e6."""
    s = sum(h * w for h, w in levels)

    def rnd(*shape):
        return torch.rand(*shape, generator=gen, device=DEV)

    value = torch.randn(b, s, nh * dh, generator=gen, device=DEV).to(vdtype)
    shape = (b, q, nh, len(levels), npts, 2)
    if from_boxes:
        boxes = torch.cat([rnd(b, q, 2), 0.02 + 0.5 * rnd(b, q, 2)], -1)[:, :, None, None, None, :]
        offsets = torch.randn(*shape, generator=gen, device=DEV)
        grids = 2 * (boxes[..., :2] + offsets / npts * boxes[..., 2:] * 0.5) - 1
    else:
        grids = (rnd(*shape) * 2 - 1) * 1.5
    grids = torch.where(rnd(*shape) < FAR_SHARE, torch.where(rnd(*shape) < 0.5, -1e6, 1e6), grids).contiguous()
    logits = torch.randn(b, q, nh, len(levels) * npts, generator=gen, device=DEV)
    weights = torch.softmax(logits, -1).reshape(b, q, nh, len(levels), npts).to(wdtype)
    return value, grids, weights


def deform_grid_sample(value, levels, grids, weights):
    """The same function as HF's pure-PyTorch
    ``multi_scale_deformable_attention``: one ``F.grid_sample`` per level
    (bilinear, zeros, align_corners=False), then the weighted sum. Timed
    beside K4 as a yardstick only; the port never calls it. grid_sample
    takes one dtype, so a bf16 value is cast to the grids' f32 first."""
    b, q, nh, nl, npts, _ = grids.shape
    dh = value.shape[-1] // nh
    start, samples = 0, []
    for li, (h, w) in enumerate(levels):
        v = value[:, start:start + h * w].to(grids.dtype).transpose(1, 2).reshape(b * nh, dh, h, w)
        g = grids[:, :, :, li].transpose(1, 2).reshape(b * nh, q, npts, 2)
        samples.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros", align_corners=False))
        start += h * w
    wts = weights.transpose(1, 2).reshape(b * nh, 1, q, nl * npts).to(grids.dtype)
    out = (torch.stack(samples, dim=-2).flatten(-2) * wts).sum(-1)  # (B*nh, dh, Q)
    return out.reshape(b, nh, dh, q).permute(0, 3, 1, 2)


def phase_deform_gather() -> dict:
    gen = torch.Generator(device=DEV).manual_seed(0)
    rows_out = []
    for name, b, q, nh, dh, levels, npts, vdt, wdt, from_boxes in DEFORM_CASES:
        value, grids, weights = deform_inputs(b, q, nh, dh, levels, npts, vdt, wdt, from_boxes, gen)
        got = deform_gather(value, levels, grids, weights)
        torch.cuda.synchronize()
        want = deform_gather_ref(value, levels, grids, weights)
        check(got.shape == want.shape == (b, q, nh, dh) and got.dtype == torch.float32, f"K4 {name} shape/dtype")
        max_abs = float((got - want).abs().max())
        tol = deform_gather_tolerance(value, weights)
        gs_err = float((deform_grid_sample(value, levels, grids, weights) - want).abs().max())
        ms = _median_ms(lambda: deform_gather(value, levels, grids, weights))
        plain_ms = _median_ms(lambda: deform_gather_ref(value, levels, grids, weights))
        gs_ms = _median_ms(lambda: deform_grid_sample(value, levels, grids, weights))
        # Each input read once and the f32 output written once. The four
        # taps' weighted sum, the attention weight and the accumulation:
        # 9 operations per channel and ~30 for a sample's position.
        samples = weights.numel()
        n_bytes = sum(t.numel() * t.element_size() for t in (value, grids, weights)) + got.numel() * 4
        bound_ms, bound_by = bound(n_bytes, samples * (9 * dh + 30), torch.float32)
        taps_gb = samples * 4 * dh * value.element_size() / 1e9
        log(
            f"[deform_gather] {name}: B={b} Q={q} nh={nh} dh={dh} levels {list(levels)} P={npts} "
            f"value {str(vdt).split('.')[-1]} weights {str(wdt).split('.')[-1]}: max_abs_err={max_abs:.3e} "
            f"(tol {tol:.3e}) {'ok' if max_abs <= tol else 'FAIL'}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"grid_sample formulation {gs_ms:.4f} ms (err {gs_err:.3e}; not a library counterpart), "
            f"bound {bound_ms:.4f} ms ({bound_by}, {n_bytes / 1e6:.1f} MB); the samples' taps are "
            f"{taps_gb:.2f} GB of L2 traffic"
        )
        check(max_abs <= tol, f"deform_gather {name} disagrees with its plain version")
        rows_out.append(dict(name=name, max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, grid_sample_ms=gs_ms,
                             bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
        del value, grids, weights, got, want
    torch.cuda.empty_cache()
    return rows_out[0]  # the encoder at the main path's dtype stands for the kernel


# --- phase 14 ----------------------------------------------------------------
def gdino_tokenize(name: str) -> np.ndarray:
    """A class name's WordPiece ids without [CLS]/[SEP], toy vocabulary."""
    return np.asarray(WordPieceTokenizer(toy_vocab()).encode(name)[1:-1])


def make_gdino_pipeline(adapter, sam, cfg: VLFMConfig, capacity, coco=None, non_coco_threshold=None):
    return DetectionPipeline(
        adapter, sam, adapter.make_query_encoder(gdino_tokenize), coco_detector=coco,
        coco_threshold=cfg.coco_threshold,
        non_coco_threshold=cfg.non_coco_threshold if non_coco_threshold is None else non_coco_threshold,
        max_detections=cfg.max_detections_per_frame, sam_frame_capacity=capacity,
    )


def phase_tiny_gdino_pipeline() -> None:
    cfg = VLFMConfig()
    gd_cpu = GroundingDinoDetector.init_random(GroundingDinoConfig.tiny_test(), seed=0, device="cpu")
    sam_cpu = SAM.init_random(SamConfig.tiny_mobile_sam(), seed=0, device="cpu")
    gd_gpu = GroundingDinoDetector(gd_cpu.cfg, copy.deepcopy(gd_cpu.module).to(DEV))
    sam_gpu = SAM(sam_cpu.cfg, copy.deepcopy(sam_cpu.module).to(DEV))
    rgb = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (3, 48, 64, 3), dtype=np.uint8))
    per_call = deformable_attentions(gd_cpu.cfg)
    for thr in (None, 0.0):
        want = make_gdino_pipeline(GroundingDinoQueryAdapter(gd_cpu, 64), sam_cpu, cfg, 2, non_coco_threshold=thr)(
            rgb, OPEN_TARGET)
        k40 = deform_gather.launches
        got = make_gdino_pipeline(GroundingDinoQueryAdapter(gd_gpu, 64), sam_gpu, cfg, 2, non_coco_threshold=thr)(
            rgb.to(DEV), OPEN_TARGET)
        torch.cuda.synchronize()
        k4 = deform_gather.launches - k40
        (gm, gv, (gx, gs, gc)), (wm, wv, (wx, ws, wc)) = got, want
        box_err = max(float((gx.cpu() - wx).abs().max()), float((gs.cpu() - ws).abs().max()))
        flips = float((gm.cpu() != wm).float().mean())
        log(
            f"[tiny-gdino] {OPEN_TARGET} at threshold {cfg.non_coco_threshold if thr is None else thr}: card vs CPU "
            f"boxes/scores max_abs_err={box_err:.3e} (tol {TINY_GDINO_BOX_ATOL}), valid equal "
            f"{bool(torch.equal(gv.cpu(), wv))}, cls equal {bool(torch.equal(gc.cpu(), wc))}, {int(wv.sum())} "
            f"detections, mask flips {flips:.2e} (tol {TINY_MASK_FLIPS}); K4 {k4} launches (expect {per_call})"
        )
        check(box_err <= TINY_GDINO_BOX_ATOL, "tiny GroundingDINO pipeline boxes differ between card and CPU")
        check(torch.equal(gv.cpu(), wv) and torch.equal(gc.cpu(), wc), "tiny GroundingDINO pipeline valid/cls")
        check(flips <= TINY_MASK_FLIPS, "tiny GroundingDINO pipeline masks differ between card and CPU")
        check(k4 == per_call, "tiny GroundingDINO: one K4 launch per deformable attention")


# --- phase 15 ----------------------------------------------------------------
def build_gdino_path():
    """GroundingDINO SwinT-OGC at full width (``GroundingDinoConfig()``),
    random weights from seed 0 cast to bf16 with the JAX rule, behind the
    pipeline adapter at 800 px."""
    gd = GroundingDinoDetector.init_random(GroundingDinoConfig(), seed=0, device=DEV)
    cast_for_serving(gd.module)
    return gd, GroundingDinoQueryAdapter(gd, image_size=800)


def phase_gdino_path(cfg, adapter, owl, sam, rgb) -> dict:
    b, h, w = rgb.shape[:3]
    k, cap = cfg.max_detections_per_frame, cfg.sam_frame_capacity
    per_pass = chain_launches(sam.cfg.tinyvit)
    coco = CocoDetector(owl, encode_queries, conf_threshold=cfg.coco_threshold, max_detections=k)
    pipe = make_gdino_pipeline(adapter, sam, cfg, cap, coco)
    pipe0 = make_gdino_pipeline(adapter, sam, cfg, cap, coco, non_coco_threshold=0.0)
    runs = [(f"{OPEN_TARGET} at threshold {cfg.non_coco_threshold}", pipe, OPEN_TARGET),
            (f"{OPEN_TARGET} at threshold 0", pipe0, OPEN_TARGET),
            (f"{COCO_TARGET} (COCO route, then the GroundingDINO retry)", pipe, COCO_TARGET)]
    deform_gather.launches = layer_norm.launches = mbconv_chain.launches = 0
    t0 = time.perf_counter()
    outs, counts = [], []
    for _, p, target in runs:
        before = (deform_gather.launches, layer_norm.launches, mbconv_chain.launches)
        outs.append(p(rgb, target))
        torch.cuda.synchronize()
        counts.append([n - n0 for n, n0 in zip((deform_gather.launches, layer_norm.launches, mbconv_chain.launches),
                                                before)])
    wall = time.perf_counter() - t0
    launches = dict(deform_gather=deform_gather.launches, layer_norm=layer_norm.launches,
                    mbconv_chain=mbconv_chain.launches)

    _, _, _, coco_valid = pipe._coco_path(rgb, COCO_TARGET)
    hit = coco_valid.any(dim=1)
    toilet = COCO_CLASSES.index(COCO_TARGET)
    for (name, _, target), out, (k4, k1, k2) in zip(runs, outs, counts):
        is_coco = target == COCO_TARGET
        frames = check_detections(name, out, b, h, w, k, 80 if is_coco else len(target.split("|")))
        passes = -(-frames // cap)
        _, valid, (_, scores, cls) = out
        log(
            f"[gdino] {name}: {int(valid.sum())} detections on {frames} of {b} frames, {passes} SAM passes, "
            f"top score {float(scores.max()):.4f}; K4 {k4} (expect {K4_PER_DETECT}), "
            f"K1 {k1} (expect {LAUNCHES_DETECT if is_coco else 0}), K2 {k2} (expect {per_pass * passes})"
        )
        check(k4 == K4_PER_DETECT, f"{name}: K4 launch count")
        check(k1 == (LAUNCHES_DETECT if is_coco else 0), f"{name}: K1 launch count")
        check(k2 == per_pass * passes, f"{name}: K2 launches per SAM pass")
        if is_coco:
            # COCO-route frames carry COCO ids; the retried frames, caption phrase 0.
            want_cls = torch.where(hit[:, None], toilet, 0).expand_as(cls)
            check(bool((cls == want_cls)[valid].all()), f"{name}: class ids by route")
            log(f"[gdino] {COCO_TARGET}: the COCO route hit {int(hit.sum())} of {b} frames, the rest took "
                f"GroundingDINO's answer")
    check(check_detections("threshold 0", outs[1], b, h, w, k, 1) == b, "threshold 0 must put detections on every frame")
    log(f"[gdino] wall {wall:.2f} s for the three calls, first calls included")
    return launches


# --- phase 16 ----------------------------------------------------------------
def device_events(prof):
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def busy_ms(events) -> float:
    """Union of the device events' intervals, so overlaps count once."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


K4_KERNEL = "deform_gather_kernel<"  # csrc/deform_gather.cu's kernel template


def phase_gdino_timing(cfg, adapter, sam, rgb, smi: str) -> None:
    pipe = make_gdino_pipeline(adapter, sam, cfg, cfg.sam_frame_capacity)
    ids, mask = pipe._queries(OPEN_TARGET)
    imgs = adapter.preprocess(rgb)
    detect_ms = wall_ms(lambda: adapter.detect(imgs, ids, mask))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        adapter.detect(imgs, ids, mask)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = device_events(prof)
    dev_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    k4 = [e for e in dev if K4_KERNEL in e.name]
    k4_ms = sum(e.time_range.elapsed_us() for e in k4) / 1e3
    busy = busy_ms(dev)
    log(
        f"[gdino-time] B={rgb.shape[0]} GroundingDINO detect: {detect_ms:.2f} ms (wall, median of 10); under "
        f"torch.profiler {wall:.2f} ms wall, {dev_ms:.2f} ms of device time in {len(dev)} device events "
        f"(idle share {1 - busy / wall:.3f}), K4 {len(k4)} launches {k4_ms:.2f} ms "
        f"({k4_ms / max(dev_ms, 1e-9):.3f} of the device time); on {smi}"
    )
    check(len(k4) == K4_PER_DETECT, "the profiler saw one K4 launch per deformable attention")
    ms = wall_ms(lambda: pipe(rgb, OPEN_TARGET))
    log(f"[gdino-time] B={rgb.shape[0]} pipeline call ({OPEN_TARGET}, GroundingDINO, gated SAM): {ms:.2f} ms "
        f"(wall, median of 10) on {smi}")


def build_main_path():
    """The full-width configuration of phase 6: policy config, map grid,
    the perception engine with random bf16 weights, and the spin's views."""
    cfg = VLFMConfig()
    spec = GridSpec2D(cfg.map_size, cfg.pixels_per_meter, cfg.map_pad)
    itm = BLIP2ITM.init_random(BLIP2ITMConfig(), seed=0, device=DEV)
    cast_for_serving(itm.module)
    engine = PerceptionEngine(itm, WordPieceTokenizer(toy_vocab()), cfg.text_prompt)
    return cfg, spec, engine, spin_views(SPIN_VIEWS)


def kernel_record(name: str, replaces: str, launches_by_path: dict, timed: dict) -> dict:
    """One kernel's entry of the JSON line: its launches on each path's run
    (counts set to 0 just before the run), and the numbers of its timed case."""
    return {
        "name": name,
        "route": "cuda",
        "source": f"vlfm_tpu_torch/csrc/{name}.cu",
        "replaces": replaces,
        "launches": sum(launches_by_path.values()),
        "launches_by_path": launches_by_path,
        **{k: timed[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    }


def main() -> None:
    smi = phase_device()
    phase_build()
    ln = phase_layer_norm()
    k3 = phase_attention()
    phase_tiny_model()
    phase_tiny_obstacle_map()

    cfg, spec, engine, views = build_main_path()
    n_params = sum(p.numel() for p in engine.itm.module.parameters())
    log(f"[main] BLIP2-ITM ViT-g/14 + Q-Former: {n_params / 1e9:.3f} B parameters, bf16 serving")

    main_run = phase_main_path(views, engine, spec, cfg)
    phase_value_map_check(views, spec, cfg)
    phase_timing(views, engine, spec, cfg, smi)
    del engine

    k2 = phase_mbconv_chain()
    phase_tiny_pipeline()
    det_cfg, det, sam, rgb = build_detection_path()
    n_det = sum(p.numel() for p in det.module.parameters())
    n_sam = sum(p.numel() for p in sam.module.parameters())
    log(f"[detect] OWL-ViT base-32 {n_det / 1e6:.1f} M + MobileSAM {n_sam / 1e6:.2f} M parameters, bf16 serving")
    det_run = phase_detection_path(det_cfg, det, sam, rgb)
    phase_detection_timing(det_cfg, det, sam, rgb, smi)

    k4 = phase_deform_gather()
    phase_tiny_gdino_pipeline()
    gd, adapter = build_gdino_path()
    n_gd = sum(p.numel() for p in gd.module.parameters())
    log(f"[gdino] GroundingDINO SwinT-OGC (Swin-T 800 px, BERT-base, 900 queries, 256 tokens): "
        f"{n_gd / 1e6:.1f} M parameters, bf16 weights")
    gdino_run = phase_gdino_path(det_cfg, adapter, det, sam, rgb)
    phase_gdino_timing(det_cfg, adapter, sam, rgb, smi)

    check(main_run["layer_norm"] > 0, "the ITM path launched no layer_norm kernel")
    check(main_run["attention"] > 0, "the ITM path launched no attention kernel")
    check(det_run["layer_norm"] > 0, "the detection path launched no layer_norm kernel")
    check(det_run["mbconv_chain"] > 0, "the detection path launched no mbconv_chain kernel")
    check(gdino_run["deform_gather"] > 0, "the GroundingDINO path launched no deform_gather kernel")
    check(gdino_run["mbconv_chain"] > 0, "the GroundingDINO path launched no mbconv_chain kernel")
    record = {
        "kernels": [
            kernel_record("layer_norm", "vlfm_tpu/ops/norms.py:41",
                          {"itm_spin": main_run["layer_norm"], "detection": det_run["layer_norm"],
                           "gdino_detection": gdino_run["layer_norm"]}, ln),
            kernel_record("mbconv_chain", "vlfm_tpu/ops/conv_fused.py:136",
                          {"detection": det_run["mbconv_chain"], "gdino_detection": gdino_run["mbconv_chain"]}, k2),
            kernel_record("attention", "vlfm_tpu/ops/attention.py:55", {"itm_spin": main_run["attention"]}, k3),
            kernel_record("deform_gather", "vlfm_tpu/ops/deform_gather.py:85",
                          {"gdino_detection": gdino_run["deform_gather"]}, k4),
        ]
    }
    print(json.dumps(record), flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
