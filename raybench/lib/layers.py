"""Arithmetic the metric readers share: end-to-end statistics over the
window, and device time a step from the profiled stretch. Every reader
returns None where its source has nothing to read (no trace, no kernel)."""
from __future__ import annotations

import numpy as np

from raybench.lib import walkcount

#: Name fragments of the walk kernels (csrc/wide_walk.cu, csrc/binary_walk.cu).
WALK_KERNELS = ("wide_group_walk", "skip_walk", "ordered_walk")
#: The host ops whose kernels are the autograd scatter.
SCATTER_OPS = ("aten::index_add_", "aten::index_add")
#: The name's start of the range autograd's engine opens around each node
#: of the backward ("autograd::engine::evaluate_function: MulBackward0").
BACKWARD_OPS = ("autograd::engine::evaluate_function",)


def rate(ctx) -> float | None:
    """Work units (rays or camera samples) of all steps of the window over
    the window's seconds."""
    if not ctx.step_s or ctx.window_s <= 0:
        return None
    return len(ctx.step_s) * ctx.work_per_step / ctx.window_s


def _p95_ms(step_s) -> float | None:
    """95th percentile (linear interpolation) of step times, in ms."""
    return float(np.percentile(np.asarray(step_s) * 1e3, 95)) if step_s else None


def p95_ms(ctx) -> float | None:
    """_p95_ms of every step of the window."""
    return _p95_ms(ctx.step_s)


def _profiled(ctx):
    p = ctx.profile
    return p if p is not None and p.n_steps and p.kernels else None


def is_walk(e, names=WALK_KERNELS) -> bool:
    return any(n in e["name"] for n in names)


def launches(ctx) -> float | None:
    p = _profiled(ctx)
    return None if p is None else len(p.kernels) / p.n_steps


def walk_ms(ctx, names=WALK_KERNELS) -> float | None:
    p = _profiled(ctx)
    if p is None:
        return None
    ms = p.kernel_s(lambda e: is_walk(e, names)) * 1e3 / p.n_steps
    return ms if ms > 0 else None


def scatter_ms(ctx, ops=SCATTER_OPS) -> float | None:
    p = _profiled(ctx)
    if p is None:
        return None
    under = p.launched_under(ops)
    return p.kernel_s(lambda e: (e.get("args") or {}).get("correlation") in under) \
        * 1e3 / p.n_steps


def backward_ms(ctx, ops=BACKWARD_OPS, scatter=SCATTER_OPS) -> float | None:
    """Kernels launched inside autograd's backward, other than under the
    scatter's ops."""
    p = _profiled(ctx)
    if p is None:
        return None
    back, under = p.launched_under(ops, prefix=True), p.launched_under(scatter)
    ms = p.kernel_s(lambda e: (c := (e.get("args") or {}).get("correlation")) in back
                    and c not in under) * 1e3 / p.n_steps
    return ms if ms > 0 else None


def integrator_ms(ctx, walks=WALK_KERNELS, scatter=SCATTER_OPS,
                  backward=BACKWARD_OPS) -> float | None:
    """The forward's kernels: neither a walk nor launched under the
    scatter's ops or inside autograd's backward."""
    p = _profiled(ctx)
    if p is None:
        return None
    out = p.launched_under(scatter) | p.launched_under(backward, prefix=True)
    return p.kernel_s(lambda e: not is_walk(e, walks)
                      and (e.get("args") or {}).get("correlation") not in out) \
        * 1e3 / p.n_steps


def idle_share(ctx) -> float | None:
    """1 - busy / window of the device-only stretch, in %."""
    if ctx.busy_s is None or not ctx.window_s_traced:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s_traced)


def p95_ms_untraced(ctx) -> float | None:
    """_p95_ms of the traced run's steps outside its traced stretches."""
    return _p95_ms(ctx.step_s_untraced)


def walk_roofline(ctx, names=WALK_KERNELS) -> float | None:
    """The walks' least time on the card (walkcount's model, one counted
    step) over their device time a profiled step, in %."""
    ms = walk_ms(ctx, names)
    if ms is None or not ctx.walk_work:
        return None
    return 100.0 * walkcount.bound_s(ctx.walk_work)[0] / (ms * 1e-3)
