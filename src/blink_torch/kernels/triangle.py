"""Ray-triangle intersection: branchless Möller–Trumbore (counterpart of
`blink.kernels.triangle`).

Triangles come as (v0, e1, e2) with e1 = v1-v0, e2 = v2-v0. Double-sided.
1/det is exact, guarded only against det == 0. Misses return T_MAX. The
CUDA walk (csrc/wide_walk.cu) repeats this arithmetic operation for
operation.
"""
from __future__ import annotations

import torch

from blink_torch.core import vec
from blink_torch.kernels.types import T_MAX


def triangle_tuv(o, d, v0, e1, e2, t_min, t_max=T_MAX):
    """(t, u, v) of the hit of rays (o, d) with triangles (v0, e1, e2), all
    (..., 3) and broadcasting; t = T_MAX on a miss or outside
    [t_min, t_max]."""
    pvec = vec.cross(d, e2)
    det = vec.vdot(e1, pvec)
    degenerate = det == 0.0
    inv_det = 1.0 / torch.where(degenerate, torch.ones_like(det), det)
    tvec = o - v0
    u = vec.vdot(tvec, pvec) * inv_det
    qvec = vec.cross(tvec, e1)
    v = vec.vdot(d, qvec) * inv_det
    t = vec.vdot(e2, qvec) * inv_det
    valid = (
        ~degenerate
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= t_min)
        & (t <= t_max)
    )
    return torch.where(valid, t, torch.full_like(t, T_MAX)), u, v


def triangle_t(o, d, v0, e1, e2, t_min, t_max=T_MAX):
    """Smallest-t Möller–Trumbore hit; T_MAX on a miss."""
    return triangle_tuv(o, d, v0, e1, e2, t_min, t_max)[0]
