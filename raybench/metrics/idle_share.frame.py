"""idle_share.frame: share of the profiled window in which no kernel, copy
or memset ran on the device, in %."""
from raybench.lib import layers


def read(ctx):
    return layers.idle_share(ctx)
