"""Host synchronisations per decision, from set_sync_debug_mode("warn") warnings."""


def read(ctx):
    return ctx.trace.syncs if ctx.trace else None
