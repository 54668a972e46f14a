"""rays_per_s_frame: camera rays of every frame completed in the window over
the window's seconds (a frame of the direct integrator casts one camera ray a
sample)."""
from raybench.lib import layers


def read(ctx):
    return layers.rate(ctx) if ctx.kind == "render" else None
