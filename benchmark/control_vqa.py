"""The veto cell's controls: T5 one and two precisions below the configuration's.

    python3 -m benchmark.control_vqa [--workload hm3d-b8-vqa] --seconds <s> --seeds <n> [<n> ...]

As ``benchmark.control`` does, for each seed it sets the cell up, drives
the port for a short window at the cell's own load and computes the
check's numbers against the reference for the port's outputs; then for
each control in the port's place: ``control`` (``benchmark.control``'s own
side: the prefix through float8 with TF32, T5's products in TF32) and
``control_bf16`` (the same prefix, T5's products in bfloat16, as LAVIS
runs it). The benchmark's own runs never run this; each seed prints one
JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark.run import ROOT, Cell, drive

SIDES = ("control", "control_bf16")


def control_numbers(cell: Cell, seed: int, seconds: float, device: str = "cuda") -> dict:
    driver = cell.driver().Driver(cell, seed, device)
    drive(driver, seconds)
    driver.close_program()
    records = [driver.records[i] for i in driver.samples]
    limits = cell.mix["check"]["limits"]
    ref = driver.reference()
    out = {"seed": seed, "program": {k: v for k, (v, _) in ref.compare(records, limits).items()}}
    for side in SIDES:
        ctl = driver.reference(side)
        outs = [ctl.outputs(rec, first=i == 0) for i, rec in enumerate(records)]
        del ctl
        out[side] = {k: v for k, (v, _) in ref.compare(outs, limits).items()}
    out["limits"] = limits
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="hm3d-b8-vqa")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = Cell(json.loads((ROOT / "BENCHMARK.json").read_text()), args.workload)
    for seed in args.seeds:
        print(json.dumps(control_numbers(cell, seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
