"""Device activities (kernels, copies, sets) per traced decision."""
from benchmark.tracing import per_decision


def read(ctx):
    return per_decision(ctx, ctx.trace.activities if ctx.trace else None)
