"""The program's map.sweeps counter per decision: flood and labelling sweeps of the obstacle map."""
from benchmark.program_trace import counted


def read(ctx):
    return counted(ctx, "map.sweeps")
