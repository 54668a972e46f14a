"""Two-level traversal: closest hit and any hit over the `tlas` backend's
structure (bvh.tlas.TlasBVH: a quantized 8-wide TLAS over the instances'
world boxes, each object's BLAS a production wide chunk).

On a CUDA tensor `traverse_closest_tlas` and `traverse_anyhit_tlas` launch
`csrc/wide_walk.cu`'s tlas_wide_group_walk, one launch a call, or raise. On
a CPU tensor they run the plain torch versions (closest_tlas_plain,
anyhit_tlas_plain), which repeat the kernel's order of work ray for ray:
the same prims, the same t, the same counts. The walk: pop the TLAS nodes
(quantized pop, children that pass pushed far to near, a leaf child as its
instance records); at each instance record the ray moves into object space
(the instance's w2o: a rounded multiply, then a rounded add, left to
right) and walks its object's BLAS by wide_group_walk's group schedule from
the best t so far. An affine map keeps the ray parameter, so object-space t
compares with the world best directly. `prim` is the instance's first
global triangle id + the object-local id.

`walk_counts` runs the kernel's counting build (-DTLAS_WALK_COUNTS), or the
plain walk's counts on the CPU: each call's TLAS pops, BLAS pops, triangle
tests and BLAS walks begun (COUNTERS).
"""
from __future__ import annotations

import ctypes

import torch

from blink_torch.bvh.tlas import TlasBVH
from blink_torch.kernels._build import check_arg
from blink_torch.kernels.traverse_wide import _slab, _walk_plain
from blink_torch.kernels.types import T_MAX, T_MIN

#: Counters of one walk call, in the kernel's order (counts[0..3]).
COUNTERS = ("tlas_pops", "blas_pops", "tri_tests", "blas_entries")
#: The -D flag of wide_walk.cu's build that counts the two-level walk.
COUNTS_DEFINES = ("TLAS_WALK_COUNTS",)
#: Launches of the production build since the last reset_launches(), by
#: entry; each wrapper adds one where it launches and nowhere else.
LAUNCHES = {"tlas_closest": 0, "tlas_anyhit": 0}
#: Rays a step of the plain walk, by device type (bounds its scratch).
_PLAIN_BATCH = {"cpu": 1 << 15, "cuda": 1 << 18}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# Plain torch version.


def _affine_rows(m, x, translate: bool) -> torch.Tensor:
    """Each row of x (M, 3) by its own affine m (M, 3, 4), left to right as
    the kernel rounds it: x0*m[:, 0] + x1*m[:, 1] + x2*m[:, 2] (+ m[:, 3])."""
    y = x[:, 0:1] * m[:, :, 0] + x[:, 1:2] * m[:, :, 1] + x[:, 2:3] * m[:, :, 2]
    return y + m[:, :, 3] if translate else y


def _walk(o, d, acc: TlasBVH, bt, any_hit: bool, t_min: float, counts=None):
    """The kernel's walk for a batch of rays (B,) from best t (or bound) bt,
    lowered in place for a closest hit. Returns the global prim (-1: none)
    or the blocked flags. `counts` (4, B) int64, when given, receives each
    ray's TLAS pops, BLAS pops, triangle tests and BLAS walks begun."""
    B, dev = o.shape[0], o.device
    top = acc.top
    objs = acc.objects()
    ix = 1.0 / d
    octant = (d[:, 0] >= 0).long() + 2 * (d[:, 1] >= 0).long() + 4 * (d[:, 2] >= 0).long()
    child = top.child.view(-1, 3)
    cap = top.max_stack + max(acc.blas_stack)
    stack = torch.zeros((B, cap), dtype=torch.int64, device=dev)  # entry 0: the root
    sp = torch.ones(B, dtype=torch.int64, device=dev)
    prim = torch.full((B,), -1, dtype=torch.int64, device=dev)
    blocked = torch.zeros(B, dtype=torch.bool, device=dev)
    shifts = 3 * torch.arange(8, device=dev)
    while True:
        act = torch.nonzero(sp > 0).squeeze(1)
        if act.numel() == 0:
            break
        spa = sp[act] - 1
        e = stack[act, spa]
        sp[act] = spa
        # TLAS pops: every child that passed pushed far to near.
        isn = e >= 0
        a, node, spn = act[isn], e[isn], spa[isn]
        if a.numel():
            if counts is not None:
                counts[0, a] += 1
            pm = top.perm[node * 8 + octant[a]].long()
            c8 = (pm[:, None] >> shifts) & 7  # (M, 8) near-first slots
            rec = child[node[:, None] * 8 + c8].long()
            w0, w1, ref = rec[..., 0], rec[..., 1], rec[..., 2]
            cnt = w0 >> 24
            q_lo = torch.stack([w0 & 255, (w0 >> 8) & 255, (w0 >> 16) & 255], -1)
            q_hi = torch.stack([w1 & 255, (w1 >> 8) & 255, (w1 >> 16) & 255], -1)
            nb = top.nbox.view(-1, 8)[node]
            org, stp = nb[:, None, 0:3], nb[:, None, 3:6]
            lo, hi = org + q_lo.float() * stp, org + q_hi.float() * stp
            need = _slab(o[a][:, None], ix[a][:, None], t_min, bt[a][:, None], lo, hi)
            leaf = need & (cnt > 0)
            inner = need & (cnt == 0) & (ref > 0)
            j = torch.arange(max(int(cnt.max()), 1), device=dev)
            val = torch.where(inner[..., None], ref[..., None], -1 - (ref[..., None] + j))
            ok = (inner[..., None] & (j == 0)) | (leaf[..., None] & (j < cnt[..., None]))
            # Far to near, a leaf's records last first: the top pops nearest.
            val = val.flip(1).flip(2).reshape(a.numel(), -1)
            ok = ok.flip(1).flip(2).reshape(a.numel(), -1)
            slot = spn[:, None] + ok.long().cumsum(1) - 1
            r, c = torch.nonzero(ok, as_tuple=True)
            stack[a[r], slot[r, c]] = val[r, c]
            sp[a] = spn + ok.sum(1)
        # Instance entries: each object's BLAS walked by group's plain walk.
        a = act[~isn]
        if a.numel() == 0:
            continue
        if counts is not None:
            counts[3, a] += 1
        inst = top.tri_id[-1 - e[~isn]].long()
        meta = acc.meta[inst].long()
        for b in torch.unique(meta[:, 3]).tolist():
            sel = meta[:, 3] == b
            rays, m = a[sel], acc.w2o[inst[sel]]
            tb = bt[rays].clone()
            pops = torch.zeros(rays.numel(), dtype=torch.int64, device=dev)
            tests = torch.zeros_like(pops)
            out = _walk_plain(_affine_rows(m, o[rays], True), _affine_rows(m, d[rays], False),
                              objs[b], tb, any_hit, t_min, "group", pops, tests)
            if counts is not None:
                counts[1, rays] += pops
                counts[2, rays] += tests
            if any_hit:
                blocked[rays[out]] = True
                sp[rays[out]] = 0
            else:
                got = out >= 0
                bt[rays[got]] = tb[got]
                prim[rays[got]] = meta[sel, 2][got] + out[got]
    return blocked if any_hit else prim.int()


def _plain(o, d, acc: TlasBVH, bound, any_hit: bool, t_min: float, counts: bool):
    n, dev = o.shape[0], o.device
    out = (torch.zeros(n, dtype=torch.bool, device=dev) if any_hit
           else torch.full((n,), -1, dtype=torch.int32, device=dev))
    per_ray = torch.zeros((4, n), dtype=torch.int64, device=dev)
    step = _PLAIN_BATCH[dev.type]
    for s in range(0, n, step):
        sl = slice(s, min(n, s + step))
        bt = bound[sl].clone()
        out[sl] = _walk(o[sl], d[sl], acc, bt, any_hit, t_min,
                        per_ray[:, sl] if counts else None)
        bound[sl] = bt
    return out, per_ray


def _closest_bound(o, t_far) -> torch.Tensor:
    """A closest hit's starting best t: min(t_far, T_MAX) (T_MAX without)."""
    t = torch.full((o.shape[0],), T_MAX, dtype=torch.float32, device=o.device)
    return t if t_far is None else torch.minimum(t_far.to(torch.float32), t)


def closest_tlas_plain(o, d, acc: TlasBVH, t_far=None, t_min: float = T_MIN,
                       counts: bool = False):
    """Plain torch closest hit over the two-level structure: (t, prim) with
    prim -1 and t = min(t_far, T_MAX) on a miss; with `counts`, also (4, N)
    int64: each ray's COUNTERS."""
    t = _closest_bound(o, t_far)
    prim, per_ray = _plain(o, d, acc, t, False, t_min, counts)
    return (t, prim, per_ray) if counts else (t, prim)


def anyhit_tlas_plain(o, d, acc: TlasBVH, t_far, t_min: float = T_MIN, counts: bool = False):
    """Plain torch any hit: True where a triangle of any instance lies at
    t_min <= t < min(t_far, T_MAX); with `counts`, also (4, N) COUNTERS."""
    bound = torch.clamp(t_far.to(torch.float32), max=T_MAX)
    blocked, per_ray = _plain(o, d, acc, bound, True, t_min, counts)
    return (blocked, per_ray) if counts else blocked


# --------------------------------------------------------------------------
# CUDA kernel.


def _lib(defines: tuple[str, ...] = ()):
    """wide_walk.cu's library built with `defines`, with the two-level entry
    point typed."""
    from blink_torch.kernels import _build

    lib = _build.load("wide_walk", defines)
    if not getattr(lib, "_blink_tlas_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tlas_walk_launch.argtypes = [i32] + [ptr] * 17 + [i32, f32, ptr]
        lib.tlas_walk_launch.restype = i32
        lib._blink_tlas_typed = True
    return lib


def _launch(any_hit: bool, o, d, acc: TlasBVH, t, out, t_min: float, counts=None) -> None:
    """One launch. Closest: t in/out, out = prim; any hit: t = t_far, out =
    blocked. counts: a (4,) int64 tensor that the counting build adds to
    (whose launches LAUNCHES does not count), or None for the production
    build."""
    n, dev = o.shape[0], o.device
    check_arg("o", o, torch.float32, (n, 3), dev)
    check_arg("d", d, torch.float32, (n, 3), dev)
    check_arg("t", t, torch.float32, (n,), dev)
    check_arg("blocked" if any_hit else "prim", out, torch.bool if any_hit else torch.int32,
              (n,), dev)
    top, n_inst = acc.top, acc.w2o.shape[0]
    nt, nb = top.n_wide, acc.perm.shape[0] // 8
    tables = [("tchild", top.child, torch.int32, (nt * 24,)),
              ("tnbox", top.nbox, torch.float32, (nt * 8,)),
              ("tperm", top.perm, torch.int32, (nt * 8,)),
              ("tinst", top.tri_id, torch.int32, (top.tri_id.shape[0],)),
              ("w2o", acc.w2o, torch.float32, (n_inst, 3, 4)),
              ("meta", acc.meta, torch.int32, (n_inst, 4)),
              ("child", acc.child, torch.int32, (nb * 24,)),
              ("nbox", acc.nbox, torch.float32, (nb * 8,)),
              ("perm", acc.perm, torch.int32, (nb * 8,)),
              ("tri", acc.tri, torch.float32, (acc.tri.shape[0], 12)),
              ("tri_id", acc.tri_id, torch.int32, (acc.tri.shape[0],))]
    for name, x, dtype, shape in tables:
        check_arg(name, x, dtype, shape, dev)
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (read as float4/int4)")
    if counts is not None:
        check_arg("counts", counts, torch.int64, (4,), dev)
    if n == 0:
        return
    err = _lib(() if counts is None else COUNTS_DEFINES).tlas_walk_launch(
        int(any_hit), o.data_ptr(), d.data_ptr(), t.data_ptr(),
        None if any_hit else out.data_ptr(), out.data_ptr() if any_hit else None,
        *(x.data_ptr() for _, x, _, _ in tables),
        None if counts is None else counts.data_ptr(), n, t_min,
        torch.cuda.current_stream(dev).cuda_stream)
    name = "tlas_anyhit" if any_hit else "tlas_closest"
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    if counts is None:
        LAUNCHES[name] += 1


def _kernel(any_hit: bool, o, d, acc: TlasBVH, t_far, t_min: float, counts=None):
    o, d = o.contiguous(), d.contiguous()
    if any_hit:
        blocked = torch.empty(o.shape[0], dtype=torch.bool, device=o.device)
        _launch(True, o, d, acc, t_far.to(torch.float32).contiguous(), blocked, t_min, counts)
        return blocked
    t = _closest_bound(o, t_far).contiguous()
    prim = torch.empty(o.shape[0], dtype=torch.int32, device=o.device)
    _launch(False, o, d, acc, t, prim, t_min, counts)
    return t, prim


def traverse_closest_tlas(o, d, acc: TlasBVH, t_far=None, t_min: float = T_MIN):
    """Closest hit over the two-level structure: (t (N,) f32, prim (N,)
    i32), prim -1 on a miss; t_far (optional, per ray) bounds the search."""
    if not o.is_cuda:
        return closest_tlas_plain(o, d, acc, t_far, t_min)
    return _kernel(False, o, d, acc, t_far, t_min)


def traverse_anyhit_tlas(o, d, acc: TlasBVH, t_far, t_min: float = T_MIN):
    """Any hit: True where a triangle is hit at t_min <= t < t_far."""
    if not o.is_cuda:
        return anyhit_tlas_plain(o, d, acc, t_far, t_min)
    return _kernel(True, o, d, acc, t_far, t_min)


def walk_counts(any_hit: bool, o, d, acc: TlasBVH, t_far=None, t_min: float = T_MIN):
    """(output, counts): the walk's output as traverse_closest_tlas's (t,
    prim) or traverse_anyhit_tlas's blocked flags, and its COUNTERS summed
    over the rays, (4,) int64 on the rays' device: the kernel's counting
    build on a CUDA device, the plain walk's counts on the CPU."""
    if not o.is_cuda:
        if any_hit:
            out, per_ray = anyhit_tlas_plain(o, d, acc, t_far, t_min, counts=True)
        else:
            *out, per_ray = closest_tlas_plain(o, d, acc, t_far, t_min, counts=True)
            out = tuple(out)
        return out, per_ray.sum(1)
    counts = torch.zeros(4, dtype=torch.int64, device=o.device)
    return _kernel(any_hit, o, d, acc, t_far, t_min, counts), counts
