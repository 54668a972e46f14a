"""Ray-sphere intersection (counterpart of `blink.kernels.sphere`).

`sphere_t` is the analytic quadratic. `sphere_pass` is the plain closest
sphere per ray; the CUDA port of `blink`'s sphere kernel
(`sphere.py::_make_sphere_kernel`) is still to come (ROADMAP.md queue 2),
so the wide backend refuses spheres on a CUDA device.
"""
from __future__ import annotations

import torch

from blink_torch.core import vec
from blink_torch.kernels.types import T_MAX


def sphere_t(o, d, center, radius, t_min, t_max=T_MAX):
    """Smallest t in [t_min, t_max] where ray o+t*d hits the sphere.

    Broadcasts: o, d (..., 3); center (..., 3); radius (...). Misses
    return T_MAX.
    """
    oc = o - center
    a = vec.vdot(d, d)
    half_b = vec.vdot(oc, d)
    c = vec.vdot(oc, oc) - radius * radius
    disc = half_b * half_b - a * c
    hit_disc = disc > 0.0
    sq = torch.sqrt(torch.where(hit_disc, disc, torch.ones_like(disc)))
    inv_a = 1.0 / a
    t0 = (-half_b - sq) * inv_a  # near root
    t1 = (-half_b + sq) * inv_a  # far root (ray origin inside sphere)
    t = torch.where(t0 >= t_min, t0, t1)
    valid = hit_disc & (t >= t_min) & (t <= t_max)
    return torch.where(valid, t, torch.full_like(t, T_MAX))


def sphere_pass(o, d, center, radius, t_min, t_max):
    """Closest sphere per ray under a per-ray cap t_max (N,): (t, prim),
    T_MAX/0 on a miss; the first minimum wins. CPU tensors only."""
    if o.is_cuda:
        raise NotImplementedError(
            "the sphere kernel is still to be ported (ROADMAP.md queue 2)"
        )
    ts = sphere_t(
        o[:, None, :], d[:, None, :], center[None], radius[None], t_min,
        t_max[:, None],
    )  # (N, S)
    t, prim = torch.min(ts, dim=1)
    return t, prim.to(torch.int32)
