"""refine_ms.frame: device ms a step of the kernels launched inside the
program's blink.refine ranges and no range nested in them: hit refinement:
shading-table rows, vertex gathers, textures and materials."""
from raybench.lib import spans


def read(ctx):
    return spans.stage_ms(ctx, "refine")
