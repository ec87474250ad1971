"""Drive vlfm_tpu_torch's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  0. device: require CUDA, print the card, its power limit and versions,
     turn TF32 off;
  1. build the CUDA kernels from ``vlfm_tpu_torch/csrc`` (nvcc, sm_90a);
  2. LayerNorm kernel against its plain version at the main path's shapes,
     with CUDA-event timings of both;
  3. tiny BLIP2-ITM: the same weights on the CPU (plain LayerNorm) and on
     the card (kernel) give the same cosines;
  4. main path at full width: BLIP2-ITM (EVA ViT-g/14 + Q-Former, random
     bf16 weights) scores a 12-view spin of the synthetic environment, the
     views fuse into the value map, a ring of waypoints is scored and the
     frontier choice and greedy controller pick an action; the kernel's
     launches are counted over this run;
  5. value-map check: injected cosines that favour view 7 must make the
     policy pick the waypoint at view 7's bearing;
  6. full-width ITM scoring time per 32-image batch;
  7. the MBConv chain kernel (K2) against its plain version at the detection
     path's shapes and at the CPU tests' ragged ones, with CUDA-event
     timings of both;
  8. tiny detection pipeline (OWL-ViT -> COCO route -> gated MobileSAM):
     the same weights on the CPU (plain versions) and on the card (K1, K2)
     give the same boxes, scores and validity, and masks within a flip
     bound;
  9. the detection path at full width: OWL-ViT base-32 and MobileSAM
     (TinyViT-5M at 1024 px), random bf16 weights, on 8 spin frames, for a
     COCO target (both routes) and a non-COCO target at threshold 0 (every
     frame detects, so gated SAM runs all its passes); K1 and K2 launches
     are counted over this run; gated masks must match ungated ones;
 10. full-width detection timings: one pipeline call at B=8 and its parts.

The last two lines of standard output are the kernels' JSON record and the
device JSON line. ``scripts/profile_torch_step.py`` breaks the time of
phases 4, 6 and 10 down by kernel.
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

from vlfm_tpu_torch.config import VLFMConfig
from vlfm_tpu_torch.kernels.build import load_library
from vlfm_tpu_torch.mapping import value_map as VM
from vlfm_tpu_torch.mapping.grid import GridSpec2D
from vlfm_tpu_torch.models.blip2_itm import BLIP2ITM, BLIP2ITMConfig
from vlfm_tpu_torch.models.coco_detector import CocoDetector
from vlfm_tpu_torch.models.owl_vit import OwlViTDetConfig, OwlViTDetector
from vlfm_tpu_torch.models.precision import cast_for_serving
from vlfm_tpu_torch.models.sam import SAM, SamConfig
from vlfm_tpu_torch.models.tinyvit import chain_launches
from vlfm_tpu_torch.models.tokenizer import WordPieceTokenizer, toy_vocab
from vlfm_tpu_torch.ops.conv_fused import chain_tolerance, kernel_route, mbconv_chain, mbconv_chain_ref
from vlfm_tpu_torch.ops.norms import bf16_tolerance, layer_norm, layer_norm_ref
from vlfm_tpu_torch.ops.resize import resize_bilinear
from vlfm_tpu_torch.parallel.detection_pipeline import DetectionPipeline
from vlfm_tpu_torch.parallel.engine import PerceptionEngine
from vlfm_tpu_torch.policy import acyclic as AC
from vlfm_tpu_torch.policy.itm import TURN_LEFT, decide, fuse_view
from vlfm_tpu_torch.runner.fake_env import EnvConfig, FakeObjectNavEnv, two_room_plan
from vlfm_tpu_torch.utils.geometry import xyz_yaw_to_tf_matrix

DEV = torch.device("cuda", 0)
TARGET = "chair"
SPIN_VIEWS = 12
RING_RADIUS_M = 2.0
HIGH_VIEW = 7
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


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


# --- phase 0 ---------------------------------------------------------------
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


# --- phase 1 ---------------------------------------------------------------
def phase_build() -> None:
    t0 = time.perf_counter()
    load_library()
    log(f"[build] csrc/*.cu -> sm_90a in {time.perf_counter() - t0:.2f} s")


# --- phase 2 ---------------------------------------------------------------
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
        log(
            f"[layer_norm] {rows}x{d} {str(dt).split('.')[-1]} eps={eps:g}: max_abs_err={max_abs:.3e} "
            f"{tol} {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
        )
        check(ok, f"layer_norm {rows}x{d} {dt} disagrees with its plain version")
        rows_out.append(dict(shape=(rows, d), max_abs_err=max_abs, ms=ms, plain_ms=plain_ms))
    return rows_out[0]  # the ViT-g serving shape stands for the kernel


# --- phase 3 ---------------------------------------------------------------
def phase_tiny_model() -> None:
    cfg = dataclasses.replace(BLIP2ITMConfig.tiny(), compute_dtype=torch.float32)
    itm_cpu = BLIP2ITM.init_random(cfg, seed=0, device="cpu")
    itm_gpu = BLIP2ITM(cfg, copy.deepcopy(itm_cpu.module).to(DEV))
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.uniform(0, 1, (3, 56, 56, 3)).astype(np.float32))
    tok = WordPieceTokenizer(toy_vocab(), max_len=16)
    ids, mask = tok.encode_batch(["a red chair", "a bed"])
    want = itm_cpu.cosine(imgs, ids, mask)
    before = layer_norm.launches
    got = itm_gpu.cosine(imgs.to(DEV), ids.to(DEV), mask.to(DEV)).cpu()
    err = float((got - want).abs().max())
    log(
        f"[tiny] cosines gpu vs cpu: max_abs_err={err:.3e} (tol {TINY_COS_ATOL}), "
        f"{layer_norm.launches - before} kernel launches"
    )
    check(err <= TINY_COS_ATOL, "tiny BLIP2-ITM cosines differ between card and CPU")
    check(layer_norm.launches > before, "tiny model on the card did not launch the kernel")


# --- phase 4 ---------------------------------------------------------------
def spin_views(n: int) -> list[dict]:
    env = FakeObjectNavEnv(two_room_plan(seed=0), EnvConfig(width=640, height=480))
    views = [env.reset()]
    views += [env.step(TURN_LEFT) for _ in range(n - 1)]
    return views


def fuse_spin(views, cosines: torch.Tensor, spec: GridSpec2D, cfg: VLFMConfig) -> VM.ValueMapState:
    state = VM.create(spec, cfg.value_channels, device=DEV)
    cam_h = cfg.camera.camera_height
    for o, cos in zip(views, cosines.to(DEV)):
        xyz = torch.tensor([o["robot_xy"][0], o["robot_xy"][1], cam_h], dtype=torch.float32, device=DEV)
        tf = xyz_yaw_to_tf_matrix(xyz, torch.tensor(o["heading"], dtype=torch.float32, device=DEV))
        depth = torch.from_numpy(o["depth"].astype(np.float32)).to(DEV)
        fuse_view(state, spec, cfg, cos, depth, tf)
    return state


def ring_decision(views, state: VM.ValueMapState, spec: GridSpec2D):
    """Score a ring of waypoints at the view bearings and choose one."""
    last = views[-1]
    robot_xy = torch.from_numpy(last["robot_xy"]).to(DEV)
    bearings = torch.tensor([o["heading"] for o in views], dtype=torch.float32, device=DEV)
    ring = robot_xy + RING_RADIUS_M * torch.stack([torch.cos(bearings), torch.sin(bearings)], 1)
    valid = torch.ones(len(views), dtype=torch.bool, device=DEV)
    dec = decide(
        state, spec, ring, valid, robot_xy,
        torch.tensor(last["heading"], dtype=torch.float32, device=DEV),
        torch.zeros(2, device=DEV), torch.tensor(-math.inf, device=DEV),
        AC.create(device=DEV),
    )
    chosen = int(torch.argmin(torch.linalg.vector_norm(ring - dec.choice.frontier, dim=1)))
    return dec, chosen


def phase_main_path(views, engine: PerceptionEngine, spec, cfg) -> dict:
    rgb = torch.from_numpy(np.stack([o["rgb"] for o in views])).to(DEV)
    layer_norm.launches = 0
    t0 = time.perf_counter()
    engine.text_features(TARGET)
    torch.cuda.synchronize()
    text_launches = layer_norm.launches
    cosines = engine.score(rgb, TARGET)
    torch.cuda.synchronize()
    image_launches = layer_norm.launches - text_launches
    state = fuse_spin(views, cosines, spec, cfg)
    dec, chosen = ring_decision(views, state, spec)
    action = int(dec.action)
    wall = time.perf_counter() - t0
    launches = layer_norm.launches
    log(
        f"[main] K1 launches: encode_texts {text_launches} (expect {LAUNCHES_TEXT}), "
        f"cosine_cached_text {image_launches} (expect {LAUNCHES_IMAGE})"
    )
    check(text_launches == LAUNCHES_TEXT, "encode_texts K1 launch count")
    check(image_launches == LAUNCHES_IMAGE, "cosine_cached_text K1 launch count")

    c = cosines.float().cpu()
    log(f"[main] cosines {tuple(c.shape)}: {[round(v, 5) for v in c[:, 0].tolist()]}")
    check(c.shape == (len(views), cfg.value_channels), "cosine shape")
    check(bool(torch.isfinite(c).all()), "cosines finite")
    check(bool(torch.isfinite(state.values).all() and torch.isfinite(state.conf).all()), "map finite")
    log(
        f"[main] chose waypoint {chosen} (bearing {math.degrees(views[chosen]['heading']):.1f} deg), "
        f"value {float(dec.choice.value):.5f}, rho {float(dec.rho):.3f} theta {float(dec.theta):.3f}, "
        f"action {action}; wall {wall:.2f} s incl. first calls"
    )
    check(action in (0, 1, 2, 3), "action is a habitat action")
    check(bool(torch.isfinite(dec.waypoint_values).all()), "waypoint values finite")
    return dict(launches=launches)


# --- phase 5 ---------------------------------------------------------------
def phase_value_map_check(views, spec, cfg) -> None:
    cos = torch.full((len(views), cfg.value_channels), 0.1)
    cos[HIGH_VIEW] = 0.9
    state = fuse_spin(views, cos, spec, cfg)
    dec, chosen = ring_decision(views, state, spec)
    log(
        f"[value-map] injected high cosine at view {HIGH_VIEW}: chose waypoint {chosen} "
        f"value {float(dec.choice.value):.4f}"
    )
    check(chosen == HIGH_VIEW, "the high-value view's waypoint was not chosen")


# --- phase 6 ---------------------------------------------------------------
def itm_batch_ms(views, engine: PerceptionEngine, batch: int = 32) -> float:
    """Median wall time of one full-width ITM scoring call on ``batch``
    preprocessed spin frames, each call ending in a device synchronise."""
    rgb = np.stack([views[i % len(views)]["rgb"] for i in range(batch)])
    itm = engine.itm
    imgs = itm.preprocess(torch.from_numpy(rgb).to(itm.device))
    feats = engine.text_features(TARGET)
    return wall_ms(lambda: itm.cosine_cached_text(imgs, feats), reps=10, warmup=3)


def phase_timing(views, engine: PerceptionEngine, smi: str) -> None:
    ms = itm_batch_ms(views, engine)
    log(
        f"[itm] full-width BLIP2-ITM B=32: {ms:.2f} ms/batch median of 10 "
        f"({32 / ms * 1e3:.1f} images/s) on {smi}"
    )


# --- phase 7 ---------------------------------------------------------------
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
        tol = "1e-5 relative" if dt == torch.float32 else "2 bf16 ulps of plain, floor 4e-3"
        log(
            f"[mbconv_chain] {shape}->{ch}->{cout} {str(dt).split('.')[-1]} res={res} "
            f"({kernel_route(x, w[0], w[4], got)}): max_abs_err={max_abs:.3e}, {ratio:.2f} of the "
            f"tolerance ({tol}), {float((err > 0).float().mean()):.2e} of elements differ "
            f"{'ok' if ratio <= 1 else 'FAIL'}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
        )
        check(ratio <= 1.0, f"mbconv_chain {shape} {dt} disagrees with its plain version")
        rows_out.append(dict(shape=shape, max_abs_err=max_abs, ms=ms, plain_ms=plain_ms))
        del x, w, got, want, err
    return rows_out[0]  # stage 0 at B=8 stands for the kernel


# --- phase 8 ---------------------------------------------------------------
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


# --- phase 9 ---------------------------------------------------------------
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


def check_detections(name, out, b, h, w, k) -> int:
    masks, valid, (xyxy, scores, cls) = out
    check(masks.shape == (b, k, h, w) and masks.dtype == torch.bool, f"{name}: mask shape")
    check(valid.shape == (b, k) and xyxy.shape == (b, k, 4), f"{name}: box shape")
    check(bool(torch.isfinite(xyxy).all() and torch.isfinite(scores.float()).all()), f"{name}: finite boxes")
    check(bool(((xyxy >= 0) & (xyxy <= 1)).all()), f"{name}: boxes in [0, 1]")
    check(not bool(masks[~valid].any()), f"{name}: masks only where valid")
    check(bool(((cls >= 0) & (cls < 80)).all()), f"{name}: class ids")
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


# --- phase 10 --------------------------------------------------------------
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


def build_main_path():
    """The full-width configuration of phase 4: policy config, map grid,
    the perception engine with random bf16 weights, and the spin's views."""
    cfg = VLFMConfig()
    spec = GridSpec2D(cfg.map_size, cfg.pixels_per_meter, cfg.map_pad)
    itm = BLIP2ITM.init_random(BLIP2ITMConfig(), seed=0, device=DEV)
    cast_for_serving(itm.module)
    engine = PerceptionEngine(itm, WordPieceTokenizer(toy_vocab()), cfg.text_prompt)
    return cfg, spec, engine, spin_views(SPIN_VIEWS)


def main() -> None:
    smi = phase_device()
    phase_build()
    ln = phase_layer_norm()
    phase_tiny_model()

    cfg, spec, engine, views = build_main_path()
    n_params = sum(p.numel() for p in engine.itm.module.parameters())
    log(f"[main] BLIP2-ITM ViT-g/14 + Q-Former: {n_params / 1e9:.3f} B parameters, bf16 serving")

    main_run = phase_main_path(views, engine, spec, cfg)
    phase_value_map_check(views, spec, cfg)
    phase_timing(views, engine, smi)
    del engine

    k2 = phase_mbconv_chain()
    phase_tiny_pipeline()
    det_cfg, det, sam, rgb = build_detection_path()
    n_det = sum(p.numel() for p in det.module.parameters())
    n_sam = sum(p.numel() for p in sam.module.parameters())
    log(f"[detect] OWL-ViT base-32 {n_det / 1e6:.1f} M + MobileSAM {n_sam / 1e6:.2f} M parameters, bf16 serving")
    det_run = phase_detection_path(det_cfg, det, sam, rgb)
    phase_detection_timing(det_cfg, det, sam, rgb, smi)

    check(main_run["launches"] > 0, "the ITM path launched no layer_norm kernel")
    check(det_run["layer_norm"] > 0, "the detection path launched no layer_norm kernel")
    check(det_run["mbconv_chain"] > 0, "the detection path launched no mbconv_chain kernel")
    record = {
        "kernels": [
            {
                "name": "layer_norm",
                "route": "cuda",
                "source": "vlfm_tpu_torch/csrc/layer_norm.cu",
                "replaces": "vlfm_tpu/ops/norms.py:41",
                "launches": det_run["layer_norm"],
                "launches_by_path": {"itm_spin": main_run["launches"], "detection": det_run["layer_norm"]},
                "max_abs_err": ln["max_abs_err"],
                "ms": ln["ms"],
                "plain_ms": ln["plain_ms"],
            },
            {
                "name": "mbconv_chain",
                "route": "cuda",
                "source": "vlfm_tpu_torch/csrc/mbconv_chain.cu",
                "replaces": "vlfm_tpu/ops/conv_fused.py:136",
                "launches": det_run["mbconv_chain"],
                "max_abs_err": k2["max_abs_err"],
                "ms": k2["ms"],
                "plain_ms": k2["plain_ms"],
            },
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
