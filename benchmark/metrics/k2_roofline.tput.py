"""K2 (ops/conv_fused.mbconv_chain) share (%) of its roofline: the sum of each traced call's bound from its shapes over the sum of its kernel time."""
from benchmark.tracing import roofline_share


def read(ctx):
    return roofline_share(ctx, "kernel.K2")
