"""walk_ms.frame: device ms a step of the walk kernels, matched by name."""
from raybench.lib import layers


def read(ctx):
    return layers.walk_ms(ctx, ("wide_group_walk", "skip_walk", "ordered_walk"))
