"""soft_ms.grad: device ms a step of the kernels launched inside the program's
blink.soft ranges and no range nested in them: the sphere-soft and mesh-soft
terms of diff/soft.py, their walks, NEE and sampler excluded."""
from raybench.lib import spans


def read(ctx):
    return spans.stage_ms(ctx, "soft")
