"""Model FLOPs utilization (%): the sum over one decision's model calls, the veto's passes at the window's mean count included, of FLOPs / peak(compute dtype), times the window's decisions, over the window's seconds (the unprofiled window)."""
from benchmark.tracing import mfu


def read(ctx):
    return mfu(ctx)
