"""launches.frame: CUDA kernel launches a step, counted in the profiled
stretch."""
from raybench.lib import layers


def read(ctx):
    return layers.launches(ctx)
