"""Share (%) of the device's time with nothing running: 100 x (1 - device busy s per traced decision / wall s per decision of the unprofiled window)."""
from benchmark.tracing import idle_share


def read(ctx):
    return idle_share(ctx)
