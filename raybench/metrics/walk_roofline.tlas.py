"""walk_roofline.tlas: the two-level walk's least time on the card
(raybench/lib/tlaswork.py: its counted pops, tests and instance entries,
its live rays) over the device time a step of its kernels, in %."""
from raybench.lib import tlaswork


def read(ctx):
    return tlaswork.roofline(ctx)
