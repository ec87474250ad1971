"""Driver: the packed fused dispatch of the HM3D evaluation over a replayed pool.

The entry the window drives is ``FullStackPerception.make_fused_step(...,
layout=...)`` of ``vlfm_tpu_torch.runner.full_stack``: per decision the host
fills the pinned packed buffer from the pre-rendered pool (``traffic.py``),
the dispatch unpacks it on the card, resets the lanes whose episode ended,
scores BLIP2-ITM, runs OWL-ViT's COCO route and its retry and gated
MobileSAM, and steps every lane's policy (maps, frontiers, PointNav), and
one (B, 4) read brings the actions back. A decision is one dispatch of all
lanes; its lane-steps are the lanes.

For the check, ``check.samples`` decisions drawn from the seed (always the
first, from a fresh state) keep their inputs, the state before and after
(copied to pinned host memory outside the decision's timed interval) and
what perception gave;
after the window ``check()`` holds them to the plain reference
(``benchmark/reference.py``).
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from benchmark import reference, stack, traffic
from benchmark.samples import copy_into, host_copy, sample_indices
from benchmark.spans import Capture, DetectorProxy, ModelProxy, PipelineProxy


def _layout(packing, lanes: int, h: int, w: int):
    return packing.build_layout([("depth", "float32", (lanes, h, w)), ("rgb", "uint8", (lanes, h, w, 3)),
                                 ("heading", "float32", (lanes,)), ("xy", "float32", (lanes, 2)),
                                 ("seeds", "int32", (lanes,)), ("steps", "int32", (lanes,)),
                                 ("reset", "uint8", (lanes,))])


class Driver:
    def __init__(self, cell, seed: int, device: str = "cuda"):
        from vlfm_tpu_torch.policy import itm as ITM
        from vlfm_tpu_torch.runner import full_stack, packing

        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        config, mix = cell.config, cell.mix
        self.ITM = ITM
        self.lanes = mix["lanes"]
        self.attempted = self.failed = 0
        cfg, spec = stack.vlfm_config(config, "program")
        self.cfg, self.spec = cfg, spec
        models = {role: stack.build_model(s, role, seed, "program", self.device)
                  for role, s in config["models"].items()}
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()  # the peak is the served state's, not the weights' f32 staging
        self.capture = Capture()
        perception = full_stack.FullStackPerception(
            cfg, itm=models["itm"], detector=models["detector"], sam=models["sam"],
            det_threshold=cfg.non_coco_threshold, device=self.device)
        perception.itm = ModelProxy(perception.itm, "perception.itm", self.capture,
                                    ("preprocess", "cosine_cached_text"))
        det = DetectorProxy(perception.pipeline.detector, self.capture)
        perception.pipeline.detector = det
        if perception.pipeline.coco_detector is not None:
            perception.pipeline.coco_detector.detector = det
        perception.pipeline = PipelineProxy(perception.pipeline, self.capture)
        self.perception = perception
        h, w = cfg.camera.height, cfg.camera.width
        self.layout = _layout(packing, self.lanes, h, w)
        self.target = config["target"]
        self.step = perception.make_fused_step(models["pointnav"], spec, cfg, self.target,
                                               version=config.get("version", "v2"), layout=self.layout)
        self.pointnav = models["pointnav"]
        pin = self.device.type == "cuda"
        self.buf = torch.empty(self.layout.total, dtype=torch.uint8, pin_memory=pin)
        self.views = packing.pack_views(self.buf.numpy(), self.layout)
        self.pool = traffic.replay_pool(mix, seed)
        check = mix["check"]
        self.samples = sample_indices(seed, check["samples"], check["within"])
        self.records: Dict[int, dict] = {}
        # Warm-up: the cell's own shapes, on a state that is then dropped.
        self.schedule = traffic.LaneSchedule(self.lanes, len(self.pool), mix["steps"], mix["stagger"])
        self.state = ITM.create_state(spec, cfg, batch=self.lanes, device=self.device)
        for _ in range(mix.get("warmup", 2)):
            self._dispatch()
        self.capture.frames.clear()
        self.schedule = traffic.LaneSchedule(self.lanes, len(self.pool), mix["steps"], mix["stagger"])
        self.state = ITM.create_state(spec, cfg, batch=self.lanes, device=self.device)
        self.host_state = [host_copy(self.state) for _ in range(2 * len(self.samples))]
        self.n = 0

    def _fill(self) -> None:
        v = self.views
        for lane, (e, f, r) in enumerate(self.schedule.current()):
            ep = self.pool[e]
            v["depth"][lane], v["rgb"][lane] = ep["depth"][f], ep["rgb"][f]
            v["heading"][lane], v["xy"][lane] = ep["heading"][f], ep["xy"][f]
            v["seeds"][lane], v["steps"][lane], v["reset"][lane] = ep["seed"], f, r

    def _dispatch(self):
        self._fill()
        out, self.state = self.step(self.state, None, self.buf)
        out = out.cpu()  # the one read back, which the next fill waits for
        self.schedule.advance()
        return out

    def decide(self):
        """One timed dispatch. A sampled decision copies the state before
        and after it to the host outside its timed interval, each copy
        waited for, so the samples cost the timed decisions nothing."""
        record = self.n in self.samples and self.n not in self.records
        if record:
            k = len(self.records)
            rec = dict(before=self.host_state[2 * k], after=self.host_state[2 * k + 1])
            copy_into(rec["before"], self.state)
            self._sync()
            self.capture.arm()
        with torch.profiler.record_function("decision"):
            a = time.perf_counter()
            self.attempted += 1
            try:
                out = self._dispatch()
                if not bool(torch.isfinite(out).all()):
                    self.failed += 1
            except Exception:
                self.failed += 1
                raise
            b = time.perf_counter()
        if record:
            # The views still hold this decision's inputs until the next fill.
            rec.update(self.capture.take(), out=out,
                       inputs={name: view.copy() for name, view in self.views.items()})
            copy_into(rec["after"], self.state)
            self._sync()
            self.records[self.n] = rec
        self.n += 1
        return self.lanes, (a, b)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # --- after the window -------------------------------------------------------
    def flops_per_decision(self):
        """[(FLOPs, compute dtype)] of one decision's model calls, the gated
        SAM passes averaged over the window's dispatches."""
        frames = [int(f) for f in self.capture.frames]
        cap = self.cfg.sam_frame_capacity or self.lanes
        if cap >= self.lanes:  # ungated: one SAM call of every frame, detections or not
            passes = 1.0
        else:
            passes = float(np.mean([-(-f // cap) for f in frames])) if frames else 0.0
        return reference.dispatch_flops(self.cell.config, self.lanes, passes)

    def summary(self) -> str:
        frames = [int(f) for f in self.capture.frames]
        return f"frames with a detection per dispatch {np.mean(frames) if frames else 0:.2f} over {len(frames)}"

    def close_program(self) -> None:
        """Run on to any sampled decision the window did not reach, then free
        the port's models and state; keep the samples on the host."""
        while any(i not in self.records for i in self.samples):
            self.decide()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        for rec in self.records.values():
            for key in ("cos", "masks", "valid", "boxes", "detects", "out"):
                if key in rec:
                    rec[key] = reference.to_host(rec[key])
        self.state = self.step = self.perception = self.pointnav = None
        self.host_state = None
        self.capture = Capture()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, side: str = "reference"):
        return reference.DispatchReference(self.cell.config, self.seed, self.device, self.lanes, side)

    def check(self) -> Dict[str, tuple]:
        """{number: (value, limit)} of the samples against the plain reference."""
        return self.reference().compare([self.records[i] for i in self.samples], self.cell.mix["check"]["limits"])
