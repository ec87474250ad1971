"""decision_ms_p90: the 90th percentile over every decision of the window, from all its samples."""
from benchmark.run import percentile


def read(ctx):
    return percentile(ctx.window.decision_ms, 90)
