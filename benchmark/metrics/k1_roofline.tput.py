"""K1 (ops/norms) share (%) of its roofline: the calls' bound from their shapes per decision over vlfm.K1's traced device time per decision."""
from benchmark.program_trace import k1_roofline


def read(ctx):
    return k1_roofline(ctx)
