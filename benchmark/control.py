"""The control of a cell's check: the reference in the port's place, one precision down.

    python3 -m benchmark.control --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed it sets the cell up and drives the port for a short window at
the cell's own load (to have its sampled decisions), then computes the
same numbers twice against the float32 reference: once for the port's
outputs (a lower reading) and once for the control's, the reference with
its bfloat16-served weights rounded through float8 (e4m3, one scale per
tensor) and TF32 on for its float32 work (an upper reading). The
benchmark's own runs never run this; each seed prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark.run import ROOT, Cell, drive


def control_numbers(cell: Cell, seed: int, seconds: float, device: str = "cuda") -> dict:
    driver = cell.driver().Driver(cell, seed, device)
    drive(driver, seconds)
    driver.close_program()
    records = [driver.records[i] for i in driver.samples]
    limits = cell.mix["check"]["limits"]
    ref = driver.reference()
    program = ref.compare(records, limits)
    ctl = driver.reference("control")
    outs = [ctl.outputs(rec, first=i == 0) for i, rec in enumerate(records)]
    del ctl
    control = ref.compare(outs, limits)
    return {"seed": seed, "program": {k: v for k, (v, _) in program.items()},
            "control": {k: v for k, (v, _) in control.items()}, "limits": limits}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = Cell(json.loads((ROOT / "BENCHMARK.json").read_text()), args.workload)
    for seed in args.seeds:
        print(json.dumps(control_numbers(cell, seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
