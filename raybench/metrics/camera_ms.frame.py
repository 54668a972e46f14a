"""camera_ms.frame: device ms a step of the kernels launched inside the
program's blink.camera ranges and no range nested in them: generate_rays,
its sampler calls excluded."""
from raybench.lib import spans


def read(ctx):
    return spans.stage_ms(ctx, "camera")
