"""samples_per_s: camera samples of every frame completed in the window over
the window's seconds."""
from raybench.lib import layers


def read(ctx):
    return layers.rate(ctx) if ctx.kind == "render" else None
