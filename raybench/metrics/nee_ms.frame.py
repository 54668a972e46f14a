"""nee_ms.frame: device ms a step of the kernels launched inside the program's
blink.nee ranges and no range nested in them: next-event estimation: light
rows and points, its shadow walk and sampler excluded."""
from raybench.lib import spans


def read(ctx):
    return spans.stage_ms(ctx, "nee")
