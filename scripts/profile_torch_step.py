"""Where the time of vlfm_tpu_torch's main path goes on one NVIDIA GPU.

    python3 scripts/profile_torch_step.py [--table PATH]

Builds the configuration of ``chip_smoke.py`` phase 4 (full-width
BLIP2-ITM with random bf16 weights, the default value map, the 12-view spin)
and measures, with TF32 off:
  1. full-width ITM scoring at B=32: ``torch.profiler`` (CPU and CUDA
     activities) over 3 calls after 3 warm-ups; device time per call by
     ATen op, and the LayerNorm kernel's launches and device time;
  2. the 12-view spin step (ITM scoring of the 12 views, fusion into the
     value map, the ring decision): median wall time of 5 after a warm-up,
     whole and its fusion-and-decision half; then one profiled step, with
     the device's busy time and idle share over the step's wall time;
  3. one detection pipeline call at B=8 (``chip_smoke.py`` phase 9's
     configuration: OWL-ViT base-32 with the COCO route and the retry,
     MobileSAM gated at 2 frames, target "toilet"): the same profiler
     method over 3 calls after 2 warm-ups, device time per call by ATen op,
     K1's and K2's launches and device time, and the device's busy time and
     idle share over one call.
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
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as S  # noqa: E402
from vlfm_tpu_torch.ops.conv_fused import mbconv_chain  # noqa: E402
from vlfm_tpu_torch.ops.norms import layer_norm  # noqa: E402

LN_KERNEL = "layer_norm_kernel<"  # csrc/layer_norm.cu's kernel template
K2_KERNELS = ("chain_tc<", "chain_simt<")  # csrc/mbconv_chain.cu's two bodies


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


def op_table(prof, calls: int, top: int) -> list[tuple[str, float, int]]:
    """(ATen op, device ms per call, launches per call), largest first."""
    rows = [
        (k.key, k.self_device_time_total / 1e3 / calls, k.count // calls)
        for k in prof.key_averages()
        if k.key.startswith("aten::") and k.self_device_time_total > 0
    ]
    return sorted(rows, key=lambda r: -r[1])[:top]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--table", help="write the full profiler tables to this file")
    args = ap.parse_args()

    smi = S.phase_device()
    S.phase_build()
    cfg, spec, engine, views = S.build_main_path()
    itm = engine.itm
    tables = []

    # 1. ITM scoring at B=32.
    calls = 3
    rgb32 = np.stack([views[i % len(views)]["rgb"] for i in range(32)])
    imgs = itm.preprocess(torch.from_numpy(rgb32).to(S.DEV))
    feats = engine.text_features(S.TARGET)
    for _ in range(3):
        itm.cosine_cached_text(imgs, feats)
    torch.cuda.synchronize()
    before = layer_norm.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            itm.cosine_cached_text(imgs, feats)
        torch.cuda.synchronize()
    wrapper_launches = (layer_norm.launches - before) // calls
    dev = device_events(prof)
    ln = [e for e in dev if LN_KERNEL in e.name]
    ln_ms = sum(e.time_range.elapsed_us() for e in ln) / 1e3 / calls
    dev_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / calls
    print(f"[itm-profile] B=32, {calls} calls on {smi}: {dev_ms:.2f} ms of device time per call")
    for name, ms, n in op_table(prof, calls, top=12):
        print(f"  {name:32s} {ms:8.3f} ms  {n:5d} launches per call")
    print(
        f"  LayerNorm kernel: {len(ln) // calls} launches per call ({wrapper_launches} by the "
        f"wrapper's count), {ln_ms:.3f} ms per call, {ln_ms / max(len(ln) // calls, 1) * 1e3:.2f} us "
        f"per launch on average"
    )
    tables.append(("ITM B=32, by op", prof.key_averages().table(sort_by="self_device_time_total", row_limit=60)))

    # 2. The 12-view spin step.
    rgb12 = torch.from_numpy(np.stack([o["rgb"] for o in views])).to(S.DEV)
    cos12 = engine.score(rgb12, S.TARGET)

    def map_half():
        return S.ring_decision(views, S.fuse_spin(views, cos12, spec, cfg), spec)

    def step():
        cos = engine.score(rgb12, S.TARGET)
        return S.ring_decision(views, S.fuse_spin(views, cos, spec, cfg), spec)

    map_ms = S.wall_ms(map_half, reps=5, warmup=1)
    step_ms = S.wall_ms(step, reps=5, warmup=1)
    print(
        f"[step] 12-view spin step on {smi}: {step_ms:.2f} ms whole, of which fusion of 12 views "
        f"+ decision {map_ms:.2f} ms (wall, median of 5)"
    )
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
    tables.append(("spin step, by op", prof.key_averages().table(sort_by="self_device_time_total", row_limit=60)))
    del engine, itm

    # 3. One detection pipeline call at B=8.
    det_cfg, det, sam, rgb = S.build_detection_path()
    pipe = S.make_pipeline(det, sam, det_cfg, det_cfg.sam_frame_capacity)
    for _ in range(2):
        out = pipe(rgb, S.COCO_TARGET)
    torch.cuda.synchronize()
    passes = -(-int(out[1].any(dim=1).sum()) // det_cfg.sam_frame_capacity)
    ln0, k20 = layer_norm.launches, mbconv_chain.launches
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
    for label, names, wrapper in (("LayerNorm kernel (K1)", (LN_KERNEL,), layer_norm.launches - ln0),
                                  ("MBConv chain kernel (K2)", K2_KERNELS, mbconv_chain.launches - k20)):
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

    if args.table:
        with open(args.table, "w") as f:
            f.write(smi + "\n")
            for title, table in tables:
                f.write(f"\n== {title}\n{table}\n")
        print(f"tables written to {args.table}")


if __name__ == "__main__":
    main()
