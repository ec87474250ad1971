"""Host ms per decision inside the program's vlfm.veto span, with the program's tracing on (the median over the program-traced decisions)."""
from benchmark.program_trace import host_ms


def read(ctx):
    return host_ms(ctx, "vlfm.veto")
