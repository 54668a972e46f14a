"""walk_roofline.frame: the walks' roofline bound (counted pops and tests,
live rays) over their device time, in %."""
from raybench.lib import layers


def read(ctx):
    return layers.walk_roofline(ctx, ("wide_group_walk", "skip_walk", "ordered_walk"))
