"""The benchmark of vlfm_tpu_torch: one cell, one seed, one line of JSON.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration in the file that names, its traffic mix in
``benchmark/workloads/<traffic>.json``, the mix's driver in
``benchmark/drivers/<driver>.py`` and each metric's reader in
``benchmark/metrics/<metric>.py``. A run makes the weights on the card from
the seed, warms the cell's shapes, drives the entry for ``--seconds``,
then (``--trace 1``) profiles a few more decisions, and finally holds what
the window produced to the plain reference. The last line of standard
output is the result; the numbers compared, each with its limit, are the
last lines of standard error and the result's last key.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vlfm_tpu")


def forbidden_modules(names) -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (``vlfm_tpu_torch`` is not ``vlfm_tpu``)."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def load_file(path: Path, name: str):
    """A module from a file whose name may hold dots (``mfu.tput.py``)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, mix and metrics."""

    def __init__(self, bench: dict, name: str, root: Path = ROOT, here: Path = HERE):
        self.here = here
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.workload = name, cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = json.loads((root / configs[self.workload["config"]]["file"]).read_text())
        self.mix = json.loads((here / "workloads" / f"{self.workload['traffic']}.json").read_text())
        self.chips = self.workload["chips"]
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]

    def driver(self):
        return load_file(self.here / "drivers" / f"{self.mix['driver']}.py", f"bench_driver_{self.mix['driver']}")

    def reader(self, metric: str):
        return load_file(self.here / "metrics" / f"{metric}.py", f"bench_metric_{metric.replace('.', '_')}")


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all samples, linear between ranks."""
    v = sorted(values)
    if not v:
        raise ValueError("no samples")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


class Window:
    """The measured window: each decision's host interval and its lane-steps."""

    def __init__(self):
        self.starts, self.ends, self.lane_steps = [], [], 0
        self.t0 = self.t1 = 0.0

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    @property
    def decision_ms(self):
        return [(b - a) * 1e3 for a, b in zip(self.starts, self.ends)]


def drive(driver, seconds: float) -> Window:
    """Decisions back to back (a closed loop) until ``seconds`` have passed;
    the window ends with the decision that crosses it. ``driver.decide()``
    returns (lane-steps, (start, end) of the decision on the host clock)."""
    w = Window()
    w.t0 = time.perf_counter()
    end = w.t0 + seconds
    now = w.t0
    while now < end:
        steps, (a, b) = driver.decide()
        w.lane_steps += steps
        w.starts.append(a)
        w.ends.append(b)
        now = time.perf_counter()
    w.t1 = now
    return w


def device_record(torch, count: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda") -> dict:
    """One run of ``cell``: set-up, window, optional trace, check. Returns
    the result object (without ``device`` when ``device`` is not a card)."""
    import torch

    from benchmark import tracing

    t0 = time.perf_counter()
    driver = cell.driver().Driver(cell, seed, device)
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    window = drive(driver, seconds)
    t1 = time.perf_counter()
    record = device_record(torch, cell.chips) if device == "cuda" else {"platform": "cpu", "count": 0}
    ctx = tracing.Context(cell=cell, driver=driver, window=window, setup_s=setup_s, record=record)
    if trace:
        tracing.trace(ctx)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    t2 = time.perf_counter()
    summary = driver.summary() if hasattr(driver, "summary") else ""
    driver.close_program()
    numbers = driver.check()
    # Last, so that it covers whatever the window, the trace and the check loaded.
    found = forbidden_modules(sys.modules)
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: {found}")
    print(f"[run] {cell.name}: set-up {setup_s:.2f} s, window {window.seconds:.2f} s ({len(window.starts)} "
          f"decisions), trace {t2 - t1:.2f} s, check {time.perf_counter() - t2:.2f} s; {summary}",
          file=sys.stderr)
    result = {
        "correct": all(v <= lim for v, lim in numbers.values()),
        "attempted": driver.attempted,
        "failed": driver.failed,
        "metrics": metrics,
        "device": record,
    }
    if trace and ctx.breakdown:
        result["breakdown"] = ctx.breakdown
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.chdir(ROOT)
    # Keep libraries from loading JAX behind the port's back.
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = Cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    except Exception:  # the run's boundary: report and fail, print no result
        traceback.print_exc()
        return 1
    for k, v in result["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
