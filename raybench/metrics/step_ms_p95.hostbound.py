"""step_ms_p95.hostbound: 95th percentile of the times of the traced run's
render_grad steps outside its traced stretches, in a cell whose device is
idle more than half of the time: a tail the host paces."""
from raybench.lib import layers


def read(ctx):
    return layers.p95_ms_untraced(ctx) if ctx.kind == "render_grad" else None
