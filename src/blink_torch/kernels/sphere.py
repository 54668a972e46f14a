"""Ray-sphere intersection (counterpart of `blink.kernels.sphere`).

`sphere_t` is the analytic quadratic, used by refine and the brute
backend. `sphere_pass` is the closest sphere per ray under a per-ray cap,
the bvh and wide backends' occlusion pass; `sphere_merge` is the same pass
merged into their closest hit. On a CUDA tensor each launches the kernel of
`csrc/sphere_pass.cu` (the port of `blink`'s `_make_sphere_kernel`) or
raises; on a CPU tensor it runs `sphere_pass_plain` or
`sphere_merge_plain`, which compute the kernel's function with the
kernel's arithmetic.
"""
from __future__ import annotations

import ctypes

import torch

from blink_torch.core import vec
from blink_torch.kernels._build import check_arg
from blink_torch.kernels.types import KIND_SPHERE, T_MAX

#: Most spheres the kernel takes (its shared-memory table; `blink`'s
#: unroll bound).
MAX_PALLAS_SPHERES = 64

#: Kernel launches since the last reset_launches(). The wrapper adds one
#: where it launches the kernel and nowhere else.
LAUNCHES = {"sphere_pass": 0, "sphere_merge": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def merge_hit(s_t, s_prim, t, kind, prim):
    """A closest hit (t, kind, prim) with a sphere pass's (s_t, s_prim)
    merged in: where s_t < t, (s_t, KIND_SPHERE, s_prim) replace the ray's
    hit. Returns (t, kind, prim)."""
    nearer = s_t < t
    return (torch.where(nearer, s_t, t), torch.where(nearer, KIND_SPHERE, kind).to(torch.int32),
            torch.where(nearer, s_prim, prim))


def sphere_merge_plain(o, d, center, radius, t_min: float, t, kind, prim):
    """The kernel's merged function in plain torch: the closest sphere of
    each ray under the cap t (N,), merged into the hit (t, kind, prim) the
    ray came with (merge_hit). Returns (t, kind, prim)."""
    return merge_hit(*sphere_pass_plain(o, d, center, radius, t_min, t), t, kind, prim)


#: The -D flag of sphere_pass.cu's empty build: the same grid, no work.
EMPTY_DEFINES = ("SPHERE_PASS_EMPTY",)


def _lib(defines: tuple[str, ...] = ()):
    """sphere_pass.cu's library built with `defines`, typed."""
    from blink_torch.kernels import _build

    return typed(_build.load("sphere_pass", defines))


def typed(lib):
    """`lib`, a loaded build of sphere_pass.cu, with its entry points'
    argument types set."""
    if not getattr(lib, "_blink_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.sphere_pass_launch.argtypes = [ptr] * 7 + [i32, i32, ctypes.c_float, ptr]
        lib.sphere_merge_launch.argtypes = [ptr] * 10 + [i32, i32, ctypes.c_float, i32, ptr]
        lib.sphere_pass_attributes.argtypes = [i32, ptr]
        for f in ("sphere_pass_launch", "sphere_merge_launch", "sphere_pass_attributes"):
            getattr(lib, f).restype = i32
        lib._blink_typed = True
    return lib


def kernel_attributes(merge: bool = False, lib=None) -> dict:
    """What the CUDA runtime reports of the kernel (of sphere_merge with
    `merge`): registers a thread, local memory a thread, resident blocks an
    SM, threads a block and resident warps an SM. `lib`: another build of
    sphere_pass.cu."""
    out = (ctypes.c_int * 4)()
    err = (lib or _lib()).sphere_pass_attributes(int(merge), ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"sphere_pass_attributes failed: cudaError {err}")
    return {"registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2],
            "threads": out[3], "warps_per_sm": out[2] * out[3] // 32}


def sphere_pass(o, d, center, radius, t_min: float, t_max):
    """Closest sphere per ray under a per-ray cap t_max (N,): (t (N,) f32,
    prim (N,) i32), T_MAX/0 where no sphere lies in [t_min, cap]. The kernel
    on a CUDA tensor (at most MAX_PALLAS_SPHERES spheres; every tensor f32
    and contiguous), the plain version on a CPU tensor."""
    if not o.is_cuda:
        return sphere_pass_plain(o, d, center, radius, t_min, t_max)
    return _kernel(o, d, center, radius, t_min, t_max)


def sphere_merge(o, d, center, radius, t_min: float, t, kind, prim):
    """sphere_merge_plain's (t, kind, prim): a closest hit (t (N,) f32,
    kind and prim (N,) i32) with the closest sphere merged in. The kernel on
    a CUDA tensor, in one launch, under sphere_pass's conditions (kind and
    prim contiguous int32), the plain version on a CPU tensor."""
    if not o.is_cuda:
        return sphere_merge_plain(o, d, center, radius, t_min, t, kind, prim)
    return _kernel(o, d, center, radius, t_min, t, merge=(kind, prim))


def _kernel(o, d, center, radius, t_min: float, t_max, merge=None, lib=None):
    """One launch of the kernel: sphere_pass's, or with `merge` = (kind,
    prim) sphere_merge's. `lib`: another build of sphere_pass.cu (such as
    the empty one), whose launches LAUNCHES does not count."""
    n, s = o.shape[0], center.shape[0]
    if s > MAX_PALLAS_SPHERES:
        raise ValueError(
            f"sphere_pass unrolls over spheres; {s} > {MAX_PALLAS_SPHERES} "
            "— use the vmapped sphere_t pass"
        )
    dev = o.device
    check_arg("o", o, torch.float32, (n, 3), dev)
    check_arg("d", d, torch.float32, (n, 3), dev)
    check_arg("t" if merge else "t_max", t_max, torch.float32, (n,), dev)
    check_arg("center", center, torch.float32, (s, 3), dev)
    check_arg("radius", radius, torch.float32, (s,), dev)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    counted, lib = lib is None, lib or _lib()
    if merge is None:
        name, out = "sphere_pass", (t, prim)
        if n == 0:
            return out
        err = lib.sphere_pass_launch(
            o.data_ptr(), d.data_ptr(), t_max.data_ptr(), center.data_ptr(),
            radius.data_ptr(), t.data_ptr(), prim.data_ptr(), n, s, t_min, stream)
    else:
        kind_in, prim_in = merge
        check_arg("kind", kind_in, torch.int32, (n,), dev)
        check_arg("prim", prim_in, torch.int32, (n,), dev)
        kind = torch.empty((n,), dtype=torch.int32, device=dev)
        name, out = "sphere_merge", (t, kind, prim)
        if n == 0:
            return out
        err = lib.sphere_merge_launch(
            o.data_ptr(), d.data_ptr(), t_max.data_ptr(), center.data_ptr(),
            radius.data_ptr(), kind_in.data_ptr(), prim_in.data_ptr(), t.data_ptr(),
            kind.data_ptr(), prim.data_ptr(), n, s, t_min, KIND_SPHERE, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    if counted:
        LAUNCHES[name] += 1
    return out
