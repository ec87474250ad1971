"""decision_ms_p50: the median over every decision of the window (observation handed over to action held on the host)."""
from benchmark.run import percentile


def read(ctx):
    return percentile(ctx.window.decision_ms, 50)
