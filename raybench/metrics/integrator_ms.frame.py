"""integrator_ms.frame: device ms a step of the forward's kernels other than
the walks: every kernel that is neither a walk nor launched under
aten::index_add_ (the autograd scatter) or inside autograd's backward."""
from raybench.lib import layers


def read(ctx):
    return layers.integrator_ms(ctx, ("wide_group_walk", "skip_walk", "ordered_walk"),
                                ("aten::index_add_", "aten::index_add"),
                                ("autograd::engine::evaluate_function",))
