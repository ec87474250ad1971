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
  6. full-width ITM scoring time per 32-image batch.

The last two lines of standard output are the kernels' JSON record and the
device JSON line. ``scripts/profile_torch_step.py`` breaks the time of
phases 4 and 6 down by kernel.
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
from vlfm_tpu_torch.models.precision import cast_for_serving
from vlfm_tpu_torch.models.tokenizer import WordPieceTokenizer, toy_vocab
from vlfm_tpu_torch.ops.norms import bf16_tolerance, layer_norm, layer_norm_ref
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
# timing batch), the ragged widths of the CPU tests, and the shapes phase 4
# gives the kernel: ViT-g and query branch at 12 views, text branch at one
# prompt of 32 tokens.
LN_CASES = [
    (8224, 1408, torch.bfloat16, 1e-6),
    (1024, 768, torch.bfloat16, 1e-12),
    (7, 96, torch.float32, 1e-6),
    (1, 33, torch.float32, 1e-6),
    (12 * 257, 1408, torch.bfloat16, 1e-6),
    (12 * 32, 768, torch.bfloat16, 1e-12),
    (32, 768, torch.bfloat16, 1e-12),
]
LN_F32_ATOL = 2e-5  # bf16: ops.norms.bf16_tolerance, one bf16 ulp of plain
TINY_COS_ATOL = 1e-3
LAUNCHES_TEXT = 25  # Q-Former text branch: embed_ln + 12 x (self_ln, ffn_text_ln)
LAUNCHES_IMAGE = 110  # ViT-g 39 x 2 + post_ln, Q-Former 1 + 12 x 2 + 6 cross_ln


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
def itm_batch_ms(views, engine: PerceptionEngine, batch: int = 32, reps: int = 10, warmup: int = 3) -> float:
    """Median wall time of one full-width ITM scoring call on ``batch``
    preprocessed spin frames, each call ending in a device synchronise."""
    rgb = np.stack([views[i % len(views)]["rgb"] for i in range(batch)])
    itm = engine.itm
    imgs = itm.preprocess(torch.from_numpy(rgb).to(itm.device))
    feats = engine.text_features(TARGET)
    for _ in range(warmup):
        itm.cosine_cached_text(imgs, feats)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        itm.cosine_cached_text(imgs, feats)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_timing(views, engine: PerceptionEngine, smi: str) -> None:
    ms = itm_batch_ms(views, engine)
    log(
        f"[itm] full-width BLIP2-ITM B=32: {ms:.2f} ms/batch median of 10 "
        f"({32 / ms * 1e3:.1f} images/s) on {smi}"
    )


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

    check(main_run["launches"] > 0, "the main path launched no layer_norm kernel")
    record = {
        "kernels": [
            {
                "name": "layer_norm",
                "route": "cuda",
                "source": "vlfm_tpu_torch/csrc/layer_norm.cu",
                "replaces": "vlfm_tpu/ops/norms.py:28",
                "launches": main_run["launches"],
                "max_abs_err": ln["max_abs_err"],
                "ms": ln["ms"],
                "plain_ms": ln["plain_ms"],
            }
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
