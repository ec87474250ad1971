"""The program's spans and counters (``vlfm_tpu_torch/utils/profiling.py``)
on the CPU: off, a tiny fused dispatch records nothing and enters no
profiler annotation; on, it records the span tree of the layers with one
root per dispatch; under ``torch.profiler`` each span is an annotation
stamped on the profiler's clock; the counters count the sweeps, SAM
passes, veto passes and T5 steps the code runs, and the veto's spans lie
under ``vlfm.veto``; the ring, the exporter and ``run.py --trace-dir``."""

import collections
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vlfm_tpu_torch import config as TCONFIG
from vlfm_tpu_torch.mapping.grid import GridSpec2D
from vlfm_tpu_torch.models import pointnav as PN
from vlfm_tpu_torch.models.blip2_vqa import BLIP2VQA, BLIP2VQAConfig
from vlfm_tpu_torch.models.sam import SAM, SamConfig
from vlfm_tpu_torch.ops import flood
from vlfm_tpu_torch.ops.norms import add_layer_norm, layer_norm
from vlfm_tpu_torch.parallel.detection_pipeline import VQAVeto
from vlfm_tpu_torch.policy import itm as ITM
from vlfm_tpu_torch.runner import fake_env as ENV
from vlfm_tpu_torch.runner import packing as PK
from vlfm_tpu_torch.runner.full_stack import FullStackPerception
from vlfm_tpu_torch.utils import profiling as P

H, W, LANES = 48, 64, 2
ROOT = Path(__file__).resolve().parent.parent

# Each span of the dispatch's tree with the span it lies in.
PARENT = {
    "vlfm.dispatch.unpack": "vlfm.dispatch", "vlfm.reset_lanes": "vlfm.dispatch", "vlfm.perceive": "vlfm.dispatch",
    "vlfm.step": "vlfm.dispatch", "vlfm.dispatch.pack": "vlfm.dispatch",
    "vlfm.itm.vision": "vlfm.perceive", "vlfm.itm.qformer": "vlfm.perceive", "vlfm.detect.coco": "vlfm.perceive",
    "vlfm.detect.open_vocab": "vlfm.perceive", "vlfm.sam": "vlfm.perceive", "vlfm.wait.sam_gate": "vlfm.perceive",
    "vlfm.map.obstacle": "vlfm.step", "vlfm.map.value": "vlfm.step", "vlfm.map.object": "vlfm.step",
    "vlfm.frontier": "vlfm.step", "vlfm.pointnav": "vlfm.step",
    "vlfm.wait.flood": "vlfm.map.obstacle", "vlfm.wait.label": "vlfm.map.obstacle",
    "vlfm.wait.itm_norm": "vlfm.itm.vision", "vlfm.wait.coco_ids": "vlfm.detect.coco", "vlfm.wait.sam_norm": "vlfm.sam",
    "vlfm.K2": "vlfm.sam",
}
DISPATCH_CHILDREN = ("vlfm.dispatch.unpack", "vlfm.reset_lanes", "vlfm.perceive", "vlfm.step", "vlfm.dispatch.pack")


@pytest.fixture(scope="module")
def dispatch():
    """A callable running n tiny packed fused dispatches (2 lanes, SAM gated
    at one frame a pass, a PointNav policy), after a first one."""
    cfg = TCONFIG.VLFMConfig(camera=TCONFIG.CameraConfig(height=H, width=W), max_frontiers=16,
                             max_frontier_cells=256, object_map_slots=8, object_map_points_per_slot=128,
                             max_detections_per_frame=4, sam_frame_capacity=1, depth_image_shape=(H, W))
    spec = GridSpec2D(512, 20, 160)
    layout = PK.build_layout([("depth", "float32", (LANES, H, W)), ("rgb", "uint8", (LANES, H, W, 3)),
                              ("heading", "float32", (LANES,)), ("xy", "float32", (LANES, 2)),
                              ("seeds", "int32", (LANES,)), ("steps", "int32", (LANES,)), ("reset", "uint8", (LANES,))])
    pointnav = PN.PointNavPolicy.init_random(0, depth_shape=(H, W), device="cpu")
    step = FullStackPerception(cfg, device="cpu").make_fused_step(pointnav, spec, cfg, "toilet", layout=layout)
    buf = torch.empty(layout.total, dtype=torch.uint8)
    views = PK.pack_views(buf.numpy(), layout)
    obs = ENV.FakeObjectNavEnv(ENV.open_room_plan(seed=0), ENV.EnvConfig(width=W, height=H)).reset()
    for j in range(LANES):
        views["depth"][j], views["rgb"][j] = obs["depth"], obs["rgb"]
        views["heading"][j], views["xy"][j] = obs["heading"], obs["robot_xy"]
    views["seeds"][:], views["reset"][:] = range(LANES), 0
    held = {"state": ITM.create_state(spec, cfg, batch=LANES, device="cpu"), "step": 0}

    def run(n):
        for _ in range(n):
            views["steps"][:] = held["step"]
            _, held["state"] = step(held["state"], None, buf)
            held["step"] += 1

    run(1)
    return run


def test_tracing_off_records_nothing_and_enters_no_annotation(dispatch, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with tracing off and no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    P.reset_spans()
    P.reset_counters()
    dispatch(1)
    assert P.spans() == []
    counted = P.counters()  # counters count whether or not tracing is on
    assert counted["sam.passes"] >= 1 and counted["map.sweeps"] >= 16


def test_tracing_on_records_the_tree_of_each_dispatch(dispatch):
    P.reset_spans()
    with P.tracing():
        dispatch(2)
    recs = P.spans()
    assert recs and all(r.name.startswith("vlfm.") for r in recs)
    by_id = {r.id: r for r in recs}
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["vlfm.dispatch", "vlfm.dispatch"]
    assert roots[1].decision == roots[0].decision + 1
    for r in recs:
        top = r
        while top.parent is not None:
            parent = by_id[top.parent]
            assert parent.start_ns <= top.start_ns <= top.end_ns <= parent.end_ns
            top = parent
        assert top in roots and r.decision == top.decision
    for name, parent in PARENT.items():
        mine = [r for r in recs if r.name == name]
        assert mine, name
        assert {by_id[r.parent].name for r in mine} == {parent}, name
    for root in roots:
        kids = collections.Counter(r.name for r in recs if r.parent == root.id)
        assert kids == {name: 1 for name in DISPATCH_CHILDREN}
    k1 = [r for r in recs if r.name == "vlfm.K1"]
    assert k1 and {r.attrs["entry"] for r in k1} <= {"plain", "add", "add_keep_sum"}
    assert all(r.attrs["x"]["dtype"] in ("float32", "bfloat16") and len(r.attrs["x"]["shape"]) >= 2 for r in k1)


def test_spans_are_annotations_on_the_profilers_clock(dispatch):
    """No ``tracing()``: a recording profiler turns the spans on."""
    P.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dispatch(1)
    recs = P.spans()
    events = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("vlfm.")]
    assert collections.Counter(r.name for r in recs) == collections.Counter(e.name() for e in events)
    diffs = []
    for name in {r.name for r in recs}:
        mine = sorted(r.start_ns for r in recs if r.name == name)
        theirs = sorted(e.start_ns() for e in events if e.name() == name)
        diffs += [abs(a - b) for a, b in zip(mine, theirs)]
    assert statistics.median(diffs) <= 50_000


def _line(lanes_lengths, cols):
    """(B, 3, cols) masks, each lane a row of its length from column 0, and
    the seed at its start. The bit-packed sweeps wrap around a lane's
    columns, so a row shorter than the grid floods one way only."""
    mask = torch.zeros(len(lanes_lengths), 3, cols, dtype=torch.bool)
    for lane, n in enumerate(lanes_lengths):
        mask[lane, 1, :n] = True
    seed = torch.zeros_like(mask)
    seed[:, 1, 0] = True
    return mask, seed


@pytest.mark.parametrize("lengths,cols", [((40,), 40), ((40, 9), 64), ((9,), 96)], ids=["plain", "packed", "short"])
def test_map_sweeps_counts_the_flood_loops_sweeps(lengths, cols):
    """A row of n pixels floods from one end in n - 1 sweeps; the loop checks
    every 16 and stops at the first check with nothing changed."""
    mask, seed = _line(lengths, cols)
    P.reset_counters()
    assert torch.equal(flood.flood_from_seed(mask, seed), mask)
    assert P.counters()["map.sweeps"] == 16 * (math.ceil((max(lengths) - 1) / 16) + 1)


def test_map_sweeps_counts_the_labelling_loops_sweeps():
    """The smallest index crosses a row of n pixels in n - 1 sweeps, checked
    every 4."""
    mask, _ = _line((40, 7), 48)
    P.reset_counters()
    labels = flood.label_components(mask, max_iters=512)
    assert int(labels[0, 1, 39]) == 48 and int(labels[1, 1, 6]) == 48
    assert P.counters()["map.sweeps"] == 4 * (math.ceil(39 / 4) + 1)


def test_a_device_counter_adds_into_counters_and_reset_clears_it():
    """A kernel adds into a counter's accumulator on its device (here a CPU
    tensor stands in for the card's); ``counters()`` adds it to the host
    count of the same name, and ``reset_counters()`` zeroes it in place."""
    P.reset_counters()
    acc = P.device_counter("test.device_sweeps", "cpu")
    assert acc.dtype == torch.int64 and acc.shape == (1,) and P.device_counter("test.device_sweeps", "cpu") is acc
    assert "test.device_sweeps" not in P.counters()
    acc += 5
    P.count("test.device_sweeps", 2)
    acc += 3
    assert P.counters()["test.device_sweeps"] == 10
    P.reset_counters()
    assert "test.device_sweeps" not in P.counters() and int(acc) == 0
    assert P.device_counter("test.device_sweeps", "cpu") is acc  # the same address after a reset


@pytest.fixture(scope="module")
def sam():
    return SAM.init_random(SamConfig.tiny_mobile_sam(), seed=0, device="cpu")


def _sam_inputs(sam, b=4):
    s = sam.cfg.vision.image_size
    gen = torch.Generator().manual_seed(0)
    imgs = torch.rand(b, s, s, 3, generator=gen) * 255.0
    lo = torch.rand(b, 2, 2, generator=gen) * 0.5
    return imgs, torch.cat([lo, lo + 0.3], dim=-1)


@pytest.mark.parametrize("n_has,capacity", [(0, 2), (1, 2), (3, 2), (4, 2), (3, 1)])
def test_sam_passes_are_the_gates_passes(sam, n_has, capacity):
    imgs, boxes = _sam_inputs(sam)
    valid = torch.zeros(4, 2, dtype=torch.bool)
    valid[:n_has, 1] = True
    P.reset_counters()
    sam.segment_boxes_gated(imgs, boxes, valid, capacity)
    c = P.counters()
    passes = math.ceil(n_has / capacity)
    assert (c.get("sam.passes", 0), c.get("sam.frames", 0)) == (passes, passes * capacity)
    assert c["sam.detection_frames"] == n_has


def test_an_ungated_sam_call_is_one_pass(sam):
    imgs, boxes = _sam_inputs(sam)
    P.reset_counters()
    P.reset_spans()
    with P.tracing():
        sam.segment_boxes(imgs, boxes)
    assert P.counters() == {"sam.passes": 1, "sam.frames": 4}
    assert [(r.name, r.attrs) for r in P.spans() if r.name == "vlfm.sam"] == [("vlfm.sam", {"frames": 4})]


@pytest.fixture(scope="module")
def bridge():
    return BLIP2VQA.init_random(BLIP2VQAConfig.tiny(), seed=0, device="cpu")


def _question(text):
    ids = np.arange(3, 11)
    return ids, ids != 0


@pytest.mark.parametrize("n_valid,capacity", [(0, 3), (1, 3), (5, 3), (6, 3), (5, 4), (5, None)])
def test_the_veto_counts_its_passes_slots_and_t5_steps(bridge, n_valid, capacity):
    """``veto.passes`` is ceil(n_valid / capacity) (one batch without a
    capacity), ``veto.slots`` the passes times the capacity (the clamped
    last window's included), and each pass's ``generate`` counts 4 decode
    steps and its rows times the prefix and question."""
    b, k, h, w = 2, 3, 24, 32
    rgb = torch.randint(0, 256, (b, h, w, 3), generator=torch.Generator().manual_seed(0), dtype=torch.uint8)
    masks = torch.zeros(b, k, h, w, dtype=torch.bool)
    masks[..., 4:12, 6:20] = True
    valid = (torch.arange(b * k) < n_valid).reshape(b, k)
    veto = VQAVeto(vqa=bridge.t5, encode_text=_question, yes_token_id=42, slot_capacity=capacity,
                   image_prefix=lambda x: bridge.image_prefix(bridge.preprocess(x)))
    P.reset_counters()
    veto(rgb, masks, valid, "toilet")
    c = P.counters()
    passes = 1 if capacity is None else math.ceil(n_valid / capacity)
    slots = b * k if capacity is None else passes * capacity
    assert (c.get("veto.passes", 0), c.get("veto.slots", 0)) == (passes, slots)
    assert c.get("veto.valid_slots") == (None if capacity is None else n_valid)
    assert c.get("t5.decode_steps", 0) == 4 * passes
    assert c.get("t5.encoder_tokens", 0) == slots * (bridge.cfg.qformer.num_queries + 8)


def test_the_veto_spans_lie_under_vlfm_veto(bridge):
    """One batched perception call with the veto gated at 2 slots: each
    pass is a ``vlfm.veto.prefix``, a ``vlfm.t5.encode`` and a
    ``vlfm.t5.decode`` under the call's one ``vlfm.veto``, which lies
    under ``vlfm.perceive``."""
    cfg = TCONFIG.VLFMConfig(camera=TCONFIG.CameraConfig(height=H, width=W), max_detections_per_frame=4,
                             sam_frame_capacity=1, use_vqa=True, vqa_slot_capacity=2)
    perception = FullStackPerception(cfg, blip2_vqa=bridge, device="cpu")
    obs = ENV.FakeObjectNavEnv(ENV.open_room_plan(seed=0), ENV.EnvConfig(width=W, height=H)).reset()
    P.reset_spans()
    P.reset_counters()
    with P.tracing():
        perception.batch(np.stack([obs["rgb"]] * LANES), "toilet")
    recs = P.spans()
    by_id = {r.id: r for r in recs}
    passes = P.counters()["veto.passes"]
    assert passes >= 1
    (veto,) = [r for r in recs if r.name == "vlfm.veto"]
    assert by_id[veto.parent].name == "vlfm.perceive"
    for name in ("vlfm.veto.prefix", "vlfm.t5.encode", "vlfm.t5.decode"):
        mine = [r for r in recs if r.name == name]
        assert len(mine) == passes and all(r.parent == veto.id for r in mine), name
    assert [r.attrs["steps"] for r in recs if r.name == "vlfm.t5.decode"] == [4] * passes


def test_k1_spans_name_the_entry_and_the_shapes():
    x = torch.randn(3, 5, 32)
    h = torch.randn(5, 32)
    scale, bias = torch.ones(32), torch.zeros(32)
    P.reset_spans()
    with P.tracing():
        layer_norm(x, scale, bias)
        add_layer_norm(x, h, scale, bias, keep_sum=True)
        add_layer_norm(x, h, scale, bias, keep_sum=False)
    recs = [r for r in P.spans() if r.name == "vlfm.K1"]
    assert [r.attrs["entry"] for r in recs] == ["plain", "add_keep_sum", "add"]
    assert recs[0].attrs == {"x": {"shape": [3, 5, 32], "dtype": "float32"}, "entry": "plain"}
    assert recs[1].attrs["h"] == {"shape": [5, 32], "dtype": "float32"}
    assert all(r.parent is None and r.decision is None for r in recs)


def test_a_full_ring_counts_its_drops_and_the_export_is_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.setattr(P._ring, "records", collections.deque(maxlen=4))
    P.reset_counters()
    with P.tracing():
        with P.span("vlfm.dispatch", decision=7):
            for _ in range(5):
                with P.span("vlfm.step", frames=2):
                    pass
        P.count("sam.passes", 3)
    kept = P.spans()
    assert [r.name for r in kept] == ["vlfm.step"] * 3 + ["vlfm.dispatch"]
    assert P.counters() == {"spans.dropped": 2, "sam.passes": 3}
    assert {r.decision for r in kept} == {7} and all(r.parent == kept[-1].id for r in kept[:3])
    P.write_spans(str(tmp_path / "spans.json"))
    trace = json.loads((tmp_path / "spans.json").read_text())
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in spans] == ["vlfm.dispatch"] + ["vlfm.step"] * 3  # by start
    assert spans[1]["args"] == {"frames": 2, "id": kept[0].id, "parent": kept[-1].id, "decision": 7}
    assert all(e["dur"] >= 0 for e in spans) and spans[0]["ts"] <= spans[1]["ts"]
    assert {e["name"]: e["args"] for e in trace["traceEvents"] if e["ph"] == "C"} == {
        "spans.dropped": {"spans.dropped": 2}, "sam.passes": {"sam.passes": 3}}


def test_run_writes_its_spans_with_trace_dir(tmp_path):
    out = tmp_path / "trace"
    subprocess.run([sys.executable, "-m", "vlfm_tpu_torch.run", "--backend", "synthetic", "--cpu", "--episodes", "1",
                    "--max-steps", "2", "--trace-dir", str(out)], cwd=ROOT, check=True, timeout=300,
                   capture_output=True)
    trace = json.loads((out / "spans.json").read_text())
    names = collections.Counter(e["name"] for e in trace["traceEvents"] if e["ph"] == "X")
    assert names["vlfm.step"] == 2 and names["vlfm.map.obstacle"] == 2
    assert trace["otherData"]["counters"]["map.sweeps"] > 0
