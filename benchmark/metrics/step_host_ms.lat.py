"""Host ms per decision inside the program's vlfm.step span (the maps, frontier choice, PointNav), with the program's tracing on."""
from benchmark.program_trace import host_ms


def read(ctx):
    return host_ms(ctx, "vlfm.step")
