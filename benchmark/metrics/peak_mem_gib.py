"""peak_mem_gib: torch.cuda.max_memory_allocated() after the window, in GiB; the count starts once the weights are loaded."""


def read(ctx):
    peak = ctx.record.get("memory_peak_bytes")
    return None if peak is None else peak / 2**30
