"""scatter_ms.grad: device ms a step of the kernels launched under
aten::index_add_: the backward of refine's gathers."""
from raybench.lib import layers


def read(ctx):
    return layers.scatter_ms(ctx, ("aten::index_add_", "aten::index_add"))
