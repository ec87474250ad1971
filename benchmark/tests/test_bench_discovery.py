"""The harness finds a configuration, a mix, a driver and a metric by file
name alone: a cell made of new files only runs, with no file edited."""

import json

from benchmark.run import Cell, run_cell

DRIVER = '''
import time


class Driver:
    attempted = failed = 0

    def __init__(self, cell, seed, device):
        self.k = cell.mix["per_decision"]

    def decide(self):
        a = time.perf_counter()
        self.attempted += 1
        return self.k, (a, time.perf_counter())

    def close_program(self):
        pass

    def check(self):
        return {"answers_off": (0.0, 0.0)}
'''


def test_a_cell_of_new_files(tmp_path):
    here = tmp_path / "benchmark"
    for d in ("configs", "workloads", "drivers", "metrics"):
        (here / d).mkdir(parents=True)
    (here / "configs" / "cfg-x.json").write_text(json.dumps({"name": "cfg-x"}))
    (here / "workloads" / "mix-x.json").write_text(json.dumps({"driver": "drv_x", "per_decision": 3}))
    (here / "drivers" / "drv_x.py").write_text(DRIVER)
    (here / "metrics" / "steps_x.per-s.py").write_text(
        "def read(ctx):\n    return ctx.window.lane_steps / ctx.window.seconds\n")
    (here / "metrics" / "setup_s.py").write_text("def read(ctx):\n    return ctx.setup_s\n")
    bench = {
        "configs": [{"name": "cfg-x", "file": "benchmark/configs/cfg-x.json"}],
        "workloads": [{"name": "cell-x", "config": "cfg-x", "traffic": "mix-x", "chips": 1}],
        "end_to_end": [{"name": "steps_x.per-s", "unit": "steps/s"}, {"name": "setup_s", "unit": "s"}],
        "per_layer": [],
    }
    cell = Cell(bench, "cell-x", root=tmp_path, here=here)
    result = run_cell(cell, seed=1, seconds=0.05, trace=False, device="cpu")
    assert result["correct"] and result["attempted"] > 0
    assert set(result["metrics"]) == {"steps_x.per-s", "setup_s"}
    assert result["metrics"]["steps_x.per-s"]["value"] > 0
