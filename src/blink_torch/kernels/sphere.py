"""Ray-sphere intersection (counterpart of `blink.kernels.sphere`).

`sphere_t` is the analytic quadratic, used by refine and the brute
backend. `sphere_pass` is the closest sphere per ray under a per-ray cap,
the wide backend's sphere pass: on a CUDA tensor it launches the kernel of
`csrc/sphere_pass.cu` (the port of `blink`'s `_make_sphere_kernel`) or
raises; on a CPU tensor it runs `sphere_pass_plain`, which computes the
kernel's function with the kernel's arithmetic.
"""
from __future__ import annotations

import ctypes

import torch

from blink_torch.core import vec
from blink_torch.kernels._build import check_arg
from blink_torch.kernels.types import T_MAX

#: Most spheres the kernel takes (its shared-memory table; `blink`'s
#: unroll bound).
MAX_PALLAS_SPHERES = 64

#: Kernel launches since the last reset_launches(). The wrapper adds one
#: where it launches the kernel and nowhere else.
LAUNCHES = {"sphere_pass": 0}


def reset_launches() -> None:
    LAUNCHES["sphere_pass"] = 0


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


def sphere_pass_plain(o, d, center, radius, t_min: float, t_max):
    """The kernel's function in plain torch: (t, prim) of the closest sphere
    per ray. best = cap = min(t_max, T_MAX); spheres in ascending order; a
    sphere wins where its root t has t_min <= t <= cap and t < best (so the
    first of tied minima wins); (T_MAX, 0) where none won.

    It differs from taking the min of `sphere_t` over spheres only where a
    root equals the cap exactly: that form returns the cap there, which the
    caller's strict `< cap` then discards, so the combined Hit is the same.
    """
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a
    best = torch.clamp(t_max.to(torch.float32), max=T_MAX)
    cap = best
    prim = torch.full(best.shape, -1, dtype=torch.int32, device=o.device)
    for s in range(center.shape[0]):
        cx, cy, cz, r = center[s, 0], center[s, 1], center[s, 2], radius[s]
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        half_b = ocx * dx + ocy * dy + ocz * dz
        c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        disc = half_b * half_b - a * c
        hit_disc = disc > 0.0
        sq = torch.sqrt(torch.where(hit_disc, disc, torch.ones_like(disc)))
        t0 = (-half_b - sq) * inv_a
        t1 = (-half_b + sq) * inv_a
        t = torch.where(t0 >= t_min, t0, t1)
        better = hit_disc & (t >= t_min) & (t <= cap) & (t < best)
        best = torch.where(better, t, best)
        prim = torch.where(better, s, prim).to(torch.int32)
    won = prim >= 0
    return torch.where(won, best, T_MAX), torch.clamp(prim, min=0)


def _lib():
    from blink_torch.kernels import _build

    lib = _build.load("sphere_pass")
    if not getattr(lib, "_blink_typed", False):
        ptr = ctypes.c_void_p
        lib.sphere_pass.argtypes = [ptr] * 6 + [ctypes.c_int, ctypes.c_int,
                                                ctypes.c_float, ptr]
        lib.sphere_pass.restype = ctypes.c_int
        lib._blink_typed = True
    return lib


def sphere_pass(o, d, center, radius, t_min: float, t_max):
    """Closest sphere per ray under a per-ray cap t_max (N,): (t (N,) f32,
    prim (N,) i32), T_MAX/0 where no sphere lies in [t_min, cap]. The kernel
    on a CUDA tensor (at most MAX_PALLAS_SPHERES spheres), the plain version
    on a CPU tensor."""
    if not o.is_cuda:
        return sphere_pass_plain(o, d, center, radius, t_min, t_max)
    n, s = o.shape[0], center.shape[0]
    if s > MAX_PALLAS_SPHERES:
        raise ValueError(
            f"sphere_pass unrolls over spheres; {s} > {MAX_PALLAS_SPHERES} "
            "— use the vmapped sphere_t pass"
        )
    dev = o.device
    tab = torch.cat([center, radius[:, None]], dim=1).to(torch.float32).contiguous()
    check_arg("o", o, torch.float32, (n, 3), dev)
    check_arg("d", d, torch.float32, (n, 3), dev)
    check_arg("t_max", t_max, torch.float32, (n,), dev)
    check_arg("spheres", tab, torch.float32, (s, 4), dev)
    if tab.data_ptr() % 16:
        raise ValueError("the sphere table must be 16-byte aligned (read as float4)")
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return t, prim
    err = _lib().sphere_pass(
        o.data_ptr(), d.data_ptr(), t_max.data_ptr(), tab.data_ptr(),
        t.data_ptr(), prim.data_ptr(), n, s, t_min,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"sphere_pass launch failed: cudaError {err}")
    LAUNCHES["sphere_pass"] += 1
    return t, prim
