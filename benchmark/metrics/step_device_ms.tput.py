"""Device ms per traced decision inside the decision but outside every layer's span (perception): the policy step (maps, frontiers, PointNav), unpacking and resets."""
from benchmark.tracing import step_ms


def read(ctx):
    return step_ms(ctx)
