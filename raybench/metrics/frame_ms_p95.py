"""frame_ms_p95: 95th percentile of the times of all frames of the window,
each from the render call to the image's copy to the host."""
from raybench.lib import layers


def read(ctx):
    return layers.p95_ms(ctx) if ctx.kind == "render" else None
