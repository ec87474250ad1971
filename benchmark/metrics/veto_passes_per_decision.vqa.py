"""The program's veto.passes counter per decision: ceil(valid slots / slot capacity) veto passes; nothing where the program has no such counter."""
from benchmark.program_trace import record


def read(ctx):
    pt = record(ctx)
    if pt is None or "veto.passes" not in pt.counters:
        return None
    return pt.counters["veto.passes"]
