"""Where the time of vlfm_tpu_torch's main path goes on one NVIDIA GPU.

    python3 scripts/profile_torch_step.py [--gdino] [--table PATH]

Builds the configuration of ``chip_smoke.py`` phase 6 (full-width
BLIP2-ITM with random bf16 weights, the default maps, the 12-view spin) and
measures, with TF32 off:
  1. full-width ITM scoring at B=32: ``torch.profiler`` (CPU and CUDA
     activities) over 3 calls after 3 warm-ups; device time per call by
     ATen op, and the LayerNorm (K1) and attention (K3) kernels' launches
     and device time;
  2. the 12-view spin step (ITM scoring of the 12 views, then per view one
     policy step with the greedy controller: the obstacle, value and object
     maps and the decision): median wall time of 5 after a warm-up, whole
     and by part (ITM, the 12 obstacle-map updates alone, the 12 policy
     steps); then one profiled step, with the device's busy time and idle
     share over the step's wall time, and device time by ATen op;
  3. one detection pipeline call at B=8 (``chip_smoke.py`` phase 11's
     configuration: OWL-ViT base-32 with the COCO route and the retry,
     MobileSAM gated at 2 frames, target "toilet"): the same profiler
     method over 3 calls after 2 warm-ups, device time per call by ATen op,
     K1's and K2's launches and device time, and the device's busy time and
     idle share over one call.
With ``--gdino`` it measures instead the GroundingDINO path of
``chip_smoke.py`` phases 15-16 (GroundingDINO SwinT-OGC at full width, bf16
weights, behind the pipeline adapter at 800 px): one detect call at B=8 on
the 8 spin frames under the profiler, 3 calls after 2 warm-ups, its device
time by ATen op and by kernel (K4's launches and device time among them),
and the device's busy time and idle share over one call; then one pipeline
call (GroundingDINO, gated MobileSAM) the same way.
``--table`` writes the full per-op and per-kernel tables to PATH. Imports
only the port, never jax.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as S  # noqa: E402
from vlfm_tpu_torch.utils.profiling import counters, reset_counters  # noqa: E402

LN_KERNEL = "layer_norm_kernel<"  # csrc/layer_norm.cu's kernel template
K3_KERNELS = ("attention_whole<", "attention_stream<", "attention_f32<")  # csrc/attention*.cu's three bodies
K2_KERNELS = ("chain_tc<", "chain_simt<")  # csrc/mbconv_chain.cu's two bodies


device_events, busy_ms = S.device_events, S.busy_ms


def op_table(prof, calls: int, top: int) -> list[tuple[str, float, int]]:
    """(ATen op, device ms per call, launches per call), largest first."""
    rows = [
        (k.key, k.self_device_time_total / 1e3 / calls, k.count // calls)
        for k in prof.key_averages()
        if k.key.startswith("aten::") and k.self_device_time_total > 0
    ]
    return sorted(rows, key=lambda r: -r[1])[:top]


def kernel_table(events, calls: int, top: int) -> list[tuple[str, float, int]]:
    """(kernel, device ms per call, launches per call), largest first."""
    by_name: dict[str, list[float]] = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    rows = [(name, sum(ts) / calls, len(ts) // calls) for name, ts in by_name.items()]
    return sorted(rows, key=lambda r: -r[1])[:top]


def profile_calls(fn, calls: int, warmup: int):
    """``calls`` calls of ``fn`` under the profiler after ``warmup`` calls:
    (profiler, device events, wall ms per call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    return prof, device_events(prof), wall


def gdino_breakdown(smi: str, tables: list) -> None:
    det_cfg, _, sam, rgb = S.build_detection_path()
    _, adapter = S.build_gdino_path()
    pipe = S.make_gdino_pipeline(adapter, sam, det_cfg, det_cfg.sam_frame_capacity)
    ids, mask = pipe._queries(S.OPEN_TARGET)
    imgs = adapter.preprocess(rgb)
    calls = 3
    for label, fn in ((f"GroundingDINO detect B={rgb.shape[0]}", lambda: adapter.detect(imgs, ids, mask)),
                      (f"pipeline call B={rgb.shape[0]} ({S.OPEN_TARGET}, GroundingDINO, gated SAM)",
                       lambda: pipe(rgb, S.OPEN_TARGET))):
        reset_counters()
        prof, dev, wall = profile_calls(fn, calls, warmup=2)
        dev_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / calls
        k4 = [e for e in dev if S.K4_KERNEL in e.name]
        k4_ms = sum(e.time_range.elapsed_us() for e in k4) / 1e3 / calls
        print(f"[gdino-profile] {label}, {calls} calls on {smi}: {wall:.2f} ms wall and {dev_ms:.2f} ms of "
              f"device time per call; K4 {len(k4) // calls} launches per call "
              f"({counters().get('K4.launches', 0) // (calls + 2)} by the wrapper's count), {k4_ms:.3f} ms, "
              f"{k4_ms / max(dev_ms, 1e-9):.3f} of the device time")
        print("  by ATen op:")
        for name, ms, n in op_table(prof, calls, top=14):
            print(f"    {name:32s} {ms:8.3f} ms  {n:5d} launches per call")
        print("  by kernel:")
        for name, ms, n in kernel_table(dev, calls, top=12):
            print(f"    {name[:90]:90s} {ms:8.3f} ms  {n:5d} launches per call")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as one:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall1 = (time.perf_counter() - t0) * 1e3
        dev1 = device_events(one)
        busy = busy_ms(dev1)
        print(f"  one call under the profiler: {wall1:.2f} ms wall, device busy {busy:.2f} ms in {len(dev1)} "
              f"device events, idle share {1 - busy / wall1:.3f}")
        tables.append((label + ", by op", prof.key_averages().table(sort_by="self_device_time_total", row_limit=60)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--table", help="write the full profiler tables to this file")
    ap.add_argument("--gdino", action="store_true", help="profile the GroundingDINO path only")
    args = ap.parse_args()

    smi = S.phase_device()
    S.phase_build()
    tables = []
    if args.gdino:
        gdino_breakdown(smi, tables)
        write_tables(args.table, smi, tables)
        return
    cfg, spec, engine, views = S.build_main_path()
    itm = engine.itm

    # 1. ITM scoring at B=32.
    calls = 3
    rgb32 = np.stack([views[i % len(views)]["rgb"] for i in range(32)])
    imgs = itm.preprocess(torch.from_numpy(rgb32).to(S.DEV))
    feats = engine.text_features(S.TARGET)
    for _ in range(3):
        itm.cosine_cached_text(imgs, feats)
    torch.cuda.synchronize()
    reset_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            itm.cosine_cached_text(imgs, feats)
        torch.cuda.synchronize()
    dev = device_events(prof)
    dev_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / calls
    print(f"[itm-profile] B=32, {calls} calls on {smi}: {dev_ms:.2f} ms of device time per call")
    for name, ms, n in op_table(prof, calls, top=12):
        print(f"  {name:32s} {ms:8.3f} ms  {n:5d} launches per call")
    launched = counters()
    for label, names, wrapper in (("LayerNorm kernel (K1)", (LN_KERNEL,), launched.get("K1.launches", 0)),
                                  ("attention kernel (K3)", K3_KERNELS, launched.get("K3.launches", 0))):
        ks = [e for e in dev if any(n in e.name for n in names)]
        ms = sum(e.time_range.elapsed_us() for e in ks) / 1e3 / calls
        n = len(ks) // calls
        print(f"  {label}: {n} launches per call ({wrapper // calls} by the wrapper's count), "
              f"{ms:.3f} ms per call, {ms / max(n, 1) * 1e3:.2f} us per launch on average")
    tables.append(("ITM B=32, by op", prof.key_averages().table(sort_by="self_device_time_total", row_limit=60)))

    # 2. The 12-view spin step, whole and by part.
    rgb12 = torch.from_numpy(np.stack([o["rgb"] for o in views])).to(S.DEV)
    observations = S.spin_observations([views], cfg)
    cos12 = engine.score(rgb12, S.TARGET)
    step, obstacle_part = S.spin_step_fns(views, engine, spec, cfg)
    parts = {
        "ITM scoring of 12 views": lambda: engine.score(rgb12, S.TARGET),
        "obstacle map, 12 updates": obstacle_part,
        "policy steps, 12 (greedy)": lambda: S.spin_steps(observations, cos12[None], spec, cfg),
    }
    step_ms = S.wall_ms(step, reps=5, warmup=1)
    print(f"[step] 12-view spin step on {smi}: {step_ms:.2f} ms whole (wall, median of 5); by part:")
    for name, fn in parts.items():
        print(f"  {name:30s} {S.wall_ms(fn, reps=5, warmup=1):8.2f} ms")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = device_events(prof)
    busy = busy_ms(dev)
    print(
        f"[step-profile] one step under the profiler: {wall:.2f} ms wall, device busy {busy:.2f} ms "
        f"in {len(dev)} device events, idle share {1 - busy / wall:.3f}"
    )
    for name, ms, n in op_table(prof, 1, top=10):
        print(f"  {name:32s} {ms:8.3f} ms  {n:5d} launches")
    tables.append(("spin step, by op", prof.key_averages().table(sort_by="self_device_time_total", row_limit=60)))
    del engine, itm

    # 3. One detection pipeline call at B=8.
    det_cfg, det, sam, rgb = S.build_detection_path()
    pipe = S.make_pipeline(det, sam, det_cfg, det_cfg.sam_frame_capacity)
    for _ in range(2):
        out = pipe(rgb, S.COCO_TARGET)
    torch.cuda.synchronize()
    passes = -(-int(out[1].any(dim=1).sum()) // det_cfg.sam_frame_capacity)
    reset_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            pipe(rgb, S.COCO_TARGET)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    dev = device_events(prof)
    dev_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / calls
    print(
        f"[det-profile] B={rgb.shape[0]} pipeline call ({S.COCO_TARGET}, {passes} gated SAM passes), {calls} calls "
        f"on {smi}: {wall:.2f} ms wall and {dev_ms:.2f} ms of device time per call"
    )
    for name, ms, n in op_table(prof, calls, top=14):
        print(f"  {name:32s} {ms:8.3f} ms  {n:5d} launches per call")
    launched = counters()
    for label, names, wrapper in (("LayerNorm kernel (K1)", (LN_KERNEL,), launched.get("K1.launches", 0)),
                                  ("MBConv chain kernel (K2)", K2_KERNELS, launched.get("K2.launches", 0))):
        ks = [e for e in dev if any(n in e.name for n in names)]
        ms = sum(e.time_range.elapsed_us() for e in ks) / 1e3 / calls
        print(f"  {label}: {len(ks) // calls} launches per call ({wrapper // calls} by the wrapper's count), "
              f"{ms:.3f} ms per call")
    tables.append(("detection pipeline B=8, by op",
                   prof.key_averages().table(sort_by="self_device_time_total", row_limit=60)))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe(rgb, S.COCO_TARGET)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = device_events(prof)
    busy = busy_ms(dev)
    print(
        f"[det-profile] one call under the profiler: {wall:.2f} ms wall, device busy {busy:.2f} ms in "
        f"{len(dev)} device events, idle share {1 - busy / wall:.3f}"
    )

    write_tables(args.table, smi, tables)


def write_tables(path, smi: str, tables: list) -> None:
    if path:
        with open(path, "w") as f:
            f.write(smi + "\n")
            for title, table in tables:
                f.write(f"\n== {title}\n{table}\n")
        print(f"tables written to {path}")


if __name__ == "__main__":
    main()
