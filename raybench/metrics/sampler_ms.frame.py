"""sampler_ms.frame: device ms a step of the kernels launched inside the
program's blink.sampler ranges and no range nested in them: the
counter-based keys and draws of core/sampler.py, wherever they run."""
from raybench.lib import spans


def read(ctx):
    return spans.stage_ms(ctx, "sampler")
