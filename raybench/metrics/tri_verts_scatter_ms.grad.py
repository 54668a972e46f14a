"""tri_verts_scatter_ms.grad: device ms a step of the kernels launched inside
the program's blink.scatter_tri_verts ranges and no range nested in them:
refine's vertex scatter in the backward, launched on autograd's device
thread."""
from raybench.lib import spans


def read(ctx):
    return spans.stage_ms(ctx, "scatter_tri_verts")
