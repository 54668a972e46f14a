"""rays_per_s_fwd_bwd: camera rays of every render_grad step completed in the
window over the window's seconds."""
from raybench.lib import layers


def read(ctx):
    return layers.rate(ctx) if ctx.kind == "render_grad" else None
