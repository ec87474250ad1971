"""setup_s: seconds from the start of set-up (weights made and loaded, the pool rendered, the warm-up decisions) to the first decision of the window."""


def read(ctx):
    return ctx.setup_s
