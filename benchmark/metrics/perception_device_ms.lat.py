"""Device ms per traced decision launched inside the perception spans (BLIP2-ITM, the detection pipeline)."""
from benchmark.tracing import span_ms


def read(ctx):
    return span_ms(ctx, "perception.")
