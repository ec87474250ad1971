"""env_steps_per_s: lane-steps completed in the window over the window's seconds."""


def read(ctx):
    return ctx.window.lane_steps / ctx.window.seconds
