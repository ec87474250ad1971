"""A tiny cell on the CPU: the harness's run with the models' test presets."""

from __future__ import annotations

import json
from pathlib import Path

from benchmark.run import ROOT, Cell

DATA = Path(__file__).resolve().parent / "data"
# The tiny cell's limits, set from its CPU readings (the port's bf16 against
# the frozen f32 copy) as the full cells' are from their chip readings.
TINY_LIMITS = {"itm_cos_rms": 0.008, "owl_gap": 0.06, "select_off": 0, "mask_off": 0.05,
               "state_gap": 1e-4, "out_off": 0.0}


def tiny_cell(cell: str = "hm3d-b8-replay", lanes: int = 2, **mix) -> Cell:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    c = Cell(bench, cell)
    c.config = json.loads((DATA / "tiny-hm3d.json").read_text())
    c.mix = {**c.mix, "lanes": lanes, "episodes": 2, "steps": 6, "spin": 2, "stagger": 2,
             "env": {"width": 64, "height": 48}, "warmup": 1,
             "check": {**c.mix["check"], "samples": 2, "within": 3, "limits": TINY_LIMITS},
             "trace": {"profiled": 2, "sync_counted": 0}, **mix}
    return c
