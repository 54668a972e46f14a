"""frame_ms_p95.hostbound: 95th percentile of the times of the traced run's
frames outside its traced stretches, in a cell whose device is idle much of
the time: a tail the host paces."""
from raybench.lib import layers


def read(ctx):
    return layers.p95_ms_untraced(ctx) if ctx.kind == "render" else None
