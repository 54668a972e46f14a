"""backward_ms.grad: device ms a step of the kernels launched inside
autograd's backward (the ranges its engine opens around each node), other
than under aten::index_add_ (scatter_ms.grad's)."""
from raybench.lib import layers


def read(ctx):
    return layers.backward_ms(ctx, ("autograd::engine::evaluate_function",),
                              ("aten::index_add_", "aten::index_add"))
