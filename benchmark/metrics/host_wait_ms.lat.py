"""Host ms per decision inside the program's vlfm.wait.* spans: the host blocked on a device value (sweep checks, the SAM gate, uploads)."""
from benchmark.program_trace import wait_ms


def read(ctx):
    return wait_ms(ctx)
