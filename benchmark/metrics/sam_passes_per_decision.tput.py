"""The program's sam.passes counter per decision: SAM passes, gated ones over the frames with a detection."""
from benchmark.program_trace import counted


def read(ctx):
    return counted(ctx, "sam.passes")
