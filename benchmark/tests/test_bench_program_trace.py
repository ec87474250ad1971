"""The readers of the program's spans and counters (``program_trace.py``):
K1's bound against PERF.md's table (NVIDIA H100: 3.35 TB/s), the phase on
a stub driver that opens the program's spans, and None where the program
recorded nothing."""

import json
import time

import pytest

from benchmark import program_trace
from benchmark.program_trace import k1_bound_s, k1_cost
from benchmark.run import ROOT, Cell
from benchmark.tracing import Context, Trace

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = ["perception_host_ms.tput", "perception_host_ms.lat", "step_host_ms.tput", "step_host_ms.lat",
       "host_wait_ms.tput", "host_wait_ms.lat", "sam_passes_per_decision.tput", "map_sweeps_per_decision.tput",
       "map_sweeps_per_decision.lat", "k1_roofline.tput"]


def test_k1_bound_matches_the_table():
    # PERF.md's kernel table, K1 and K1+: (8224, 1408) bf16 0.0138 ms (2 passes); (2056, 1408) 0.0035 ms; the fused
    # entry there 0.0069 ms with the sum kept (4 passes); its position add (h 257 rows) 0.0054; post-norm 0.0052 (3)
    ms = lambda b: b / 3.35e12 * 1e3  # noqa: E731
    assert ms(k1_cost((8224, 1408), "bfloat16")) == pytest.approx(0.0138, abs=5e-5)
    assert ms(k1_cost((8, 257, 1408), "bfloat16")) == pytest.approx(0.0035, abs=5e-5)
    assert ms(k1_cost((8, 257, 1408), "bfloat16", "add_keep_sum", (8, 257, 1408))) == pytest.approx(0.0069, abs=5e-5)
    assert ms(k1_cost((8, 257, 1408), "bfloat16", "add_keep_sum", (1, 257, 1408))) == pytest.approx(0.0054, abs=5e-5)
    assert ms(k1_cost((8, 257, 1408), "bfloat16", "add", (8, 257, 1408))) == pytest.approx(0.0052, abs=5e-5)
    attrs = {"x": {"shape": [2056, 1408], "dtype": "bfloat16"}, "h": {"shape": [2056, 1408], "dtype": "bfloat16"},
             "entry": "add_keep_sum"}
    assert k1_bound_s(attrs) * 1e3 == pytest.approx(0.0069, abs=5e-5)


def test_every_new_metric_has_its_entry():
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    for name in NEW:
        assert per_layer[name]["source"] == "program_counter"
        assert per_layer[name]["workloads"] == ["hm3d-b8-replay" if name.endswith(".tput") else "hm3d-b1-replay"]


class StubDriver:
    """Decisions that run ``body`` (the program's spans, or nothing)."""

    def __init__(self, body=None):
        self.body, self.n = body, 0

    def decide(self):
        if self.body:
            self.body(self.n)
        self.n += 1
        return 1, (0.0, 0.010)


def _ctx(driver, trace=None):
    cell = Cell(BENCH, "hm3d-b8-replay")
    return cell, Context(cell=cell, driver=driver, window=None, setup_s=0.0, record={}, trace=trace)


def _read_all(cell, ctx):
    return {name: cell.reader(name).read(ctx) for name in NEW}


def test_readers_give_none_where_the_program_recorded_nothing():
    cell, ctx = _ctx(StubDriver())
    assert _read_all(cell, ctx) == {name: None for name in NEW}
    assert ctx.driver.n == cell.mix["trace"]["profiled"]  # one phase for every reader


def test_readers_give_none_on_a_program_without_spans(monkeypatch):
    from vlfm_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "tracing")
    cell, ctx = _ctx(StubDriver(lambda n: None))
    assert _read_all(cell, ctx) == {name: None for name in NEW}
    assert ctx.driver.n == 0


def test_readers_read_the_programs_spans_and_counters():
    import torch

    from vlfm_tpu_torch.utils import profiling as P

    x = torch.empty(2056, 1408, dtype=torch.bfloat16, device="meta")

    def body(n):
        with P.span("vlfm.dispatch", decision=n):
            with P.span("vlfm.perceive"):
                if n == 0:  # one slow decision moves no median
                    time.sleep(0.05)
                with P.span("vlfm.K1", x=x, entry="plain"):
                    pass
                with P.span("vlfm.wait.sam_gate"):
                    pass
                P.count("sam.passes", 4)
            with P.span("vlfm.step"):
                P.count("map.sweeps", 96)

    trace = Trace(decisions=2, activities=1, span_device_s={"vlfm.K1": 2 * 0.0035e-3 / 0.5})
    cell, ctx = _ctx(StubDriver(body), trace)
    got = _read_all(cell, ctx)
    assert got["sam_passes_per_decision.tput"] == 4 and got["map_sweeps_per_decision.lat"] == 96
    assert 10 > got["perception_host_ms.tput"] > got["host_wait_ms.tput"] > 0 and got["step_host_ms.lat"] > 0
    assert got["k1_roofline.tput"] == pytest.approx(50.0, rel=2e-2)
    pt = program_trace.record(ctx)
    assert pt.decision_ms == pytest.approx([10.0] * cell.mix["trace"]["profiled"])
    assert len(pt.host_ms["vlfm.dispatch"]) == len(pt.wait_ms) == cell.mix["trace"]["profiled"]

