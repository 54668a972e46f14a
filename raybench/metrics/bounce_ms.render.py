"""bounce_ms.render: device ms a step of the kernels launched inside the
program's blink.bounce ranges and no range nested in them: li_path's
radiance update, next direction, throughput and roulette, its sampler
excluded."""
from raybench.lib import spans


def read(ctx):
    return spans.stage_ms(ctx, "bounce")
