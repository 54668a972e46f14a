"""Wide-BVH traversal: closest hit and any hit over a list of quantized
8-wide BVH chunks (counterpart of the wide part of
`blink.kernels.traverse_pallas`: the host chunk builder, the
`_make_kernel_wide` walk with `quant=True`, `leaf_mode='group'`, and the
chunk threading of `traverse_closest_wide`/`traverse_anyhit_wide`).

On a CUDA tensor, `traverse_closest_wide` and `traverse_anyhit_wide`
launch the hand-written kernels of `csrc/wide_walk.cu`, one launch per
chunk, or raise. On a CPU tensor they run the plain torch versions,
`closest_wide_plain` and `anyhit_wide_plain`: a batched walk with a
(rays, max_stack) stack tensor that repeats the kernel's arithmetic and
visit order ray for ray, so the two agree bit for bit.

What the walk computes, per ray and chunk: pop a wide node; decode its 8
child boxes as `o + q*s` (a rounded multiply, then a rounded add); slab-test
them against the ray's best t at the pop (NaN-propagating min/max, then a
NaN near becomes -inf and a NaN far +inf); test the leaf children's
triangles in near-first child order and slot order with a strict `<`
merge; push the internal children so that the nearest pops first. The
child order comes from the ray's own direction octant. Chunks run in list
order (near to far from the build-time camera) and thread the best t, or
the blocked flags. A ray with t_far = 0 fails every slab test.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from blink_torch.bvh.build import _morton3
from blink_torch.bvh.sah import build_sah_bvh
from blink_torch.bvh.wide import WIDE_STACK_CAP, WideBVH, build_wide
from blink_torch.kernels._build import check_arg
from blink_torch.kernels.triangle import triangle_t
from blink_torch.kernels.types import T_MAX, T_MIN

#: Triangles per chunk by default (the production backend passes 340k).
CHUNK_TRIS = 120_000
#: Leaf size of the binary SAH trees that build_wide collapses.
SAH_LEAF = 4

#: Kernel launches since the last reset_launches(), by kernel name. Each
#: wrapper adds one where it launches its kernel and nowhere else.
LAUNCHES = {"wide_closest": 0, "wide_anyhit": 0}

#: Rays per step of the plain walk: bounds its scratch memory.
_PLAIN_BATCH = 1 << 15


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# Host half: chunked SAH trees collapsed to quantized wide BVHs (numpy).
# --------------------------------------------------------------------------


def _chunked_sah_trees(verts, idx, chunk_tris: int, order_from=None):
    """Morton-partition triangles into chunks of `chunk_tris`; one SAH
    FlatBVH per chunk with global triangle ids. With `order_from` (a point,
    the camera origin at build time) the chunks are sorted near to far from
    it: the threaded best t then prunes later chunks for primary rays."""
    v = np.asarray(verts, np.float32)
    idx = np.asarray(idx, np.int64)
    T = idx.shape[0]
    if T <= chunk_tris:
        return [build_sah_bvh(v, idx, SAH_LEAF)]
    cent = (v[idx[:, 0]] + v[idx[:, 1]] + v[idx[:, 2]]) / 3.0
    lo = cent.min(axis=0)
    hi = cent.max(axis=0)
    order = np.argsort(
        _morton3((cent - lo) / np.maximum(hi - lo, 1e-12)), kind="stable"
    )
    n_chunks = -(-T // chunk_tris)
    out = []
    dists = []
    for c in range(n_chunks):
        sel = order[c * chunk_tris : (c + 1) * chunk_tris]
        bvh = build_sah_bvh(v, idx[sel], SAH_LEAF)
        # Local tri ids (positions in `sel`) -> global tri ids.
        tid = bvh.tri_id
        glob = np.where(tid >= 0, sel[np.clip(tid, 0, len(sel) - 1)], -1)
        out.append(dataclasses.replace(bvh, tri_id=glob.astype(np.int32)))
        if order_from is not None:
            lo = cent[sel].min(axis=0)
            hi = cent[sel].max(axis=0)
            # Distance from the viewpoint to the chunk's centroid box.
            p = np.asarray(order_from, np.float32).reshape(3)
            dists.append(float(np.linalg.norm(np.maximum(
                np.maximum(lo - p, p - hi), 0.0))))
    if order_from is not None:
        out = [out[i] for i in np.argsort(np.asarray(dists), kind="stable")]
    return out


def pad_chunks_uniform(chunks: list[WideBVH]) -> list[WideBVH]:
    """Pad a WideBVH list to shared shapes (n_wide, records, max_stack).
    Appended nodes and records are unreachable."""
    n_wide = max(c.n_wide for c in chunks)
    n_rec = max(c.tri.shape[0] for c in chunks)
    stack = max(c.max_stack for c in chunks)

    def pad(a: np.ndarray, n: int) -> np.ndarray:
        return np.concatenate([a, np.zeros((n - a.shape[0],) + a.shape[1:], a.dtype)])

    out = []
    for c in chunks:
        out.append(dataclasses.replace(
            c, child=pad(c.child, n_wide * 24), nbox=pad(c.nbox, n_wide * 8),
            perm=pad(c.perm, n_wide * 8), tri=pad(c.tri, n_rec),
            tri_id=pad(c.tri_id, n_rec), n_wide=n_wide, max_stack=stack,
        ))
    return out


def build_chunked_wide(tris, chunk_tris: int = CHUNK_TRIS, wide_leaf: int = 32,
                       order_from=None) -> list[WideBVH]:
    """Chunked quantized WideBVH list, padded to shared shapes when there
    is more than one chunk. `wide_leaf` is the traversal leaf chosen at
    collapse time."""
    verts = tris.verts.detach().cpu().numpy()
    idx = tris.idx.cpu().numpy()
    chunks = [
        build_wide(b, wide_leaf=wide_leaf)
        for b in _chunked_sah_trees(verts, idx, chunk_tris, order_from=order_from)
    ]
    if len(chunks) > 1:
        chunks = pad_chunks_uniform(chunks)
    return chunks


@dataclasses.dataclass(frozen=True)
class WideChunk:
    """One WideBVH's tables as tensors on the device that walks them."""

    child: torch.Tensor  # (n_wide*24,) i32
    nbox: torch.Tensor  # (n_wide*8,) f32
    perm: torch.Tensor  # (n_wide*8,) i32
    tri: torch.Tensor  # (P, 12) f32
    tri_id: torch.Tensor  # (P,) i32
    max_stack: int

    @staticmethod
    def from_host(w: WideBVH, device) -> "WideChunk":
        return WideChunk(
            child=torch.as_tensor(w.child).to(device),
            nbox=torch.as_tensor(w.nbox).to(device),
            perm=torch.as_tensor(w.perm).to(device),
            tri=torch.as_tensor(w.tri).to(device),
            tri_id=torch.as_tensor(w.tri_id).to(device),
            max_stack=w.max_stack,
        )


# --------------------------------------------------------------------------
# Plain torch versions.
# --------------------------------------------------------------------------


def _slab(o, ix, t_min, t_max, lo, hi):
    """Slab test of rays against boxes: o, ix (M, 1, 3) against lo, hi
    (M, 8, 3), t_max (M, 1) -> (M, 8) bool. Min/max propagate NaN as jnp
    does; a NaN near then reads -inf and a NaN far +inf."""
    t0 = (lo - o) * ix
    t1 = (hi - o) * ix
    tn = torch.minimum(t0, t1)
    tf = torch.maximum(t0, t1)
    near = torch.maximum(torch.maximum(tn[..., 0], tn[..., 1]), tn[..., 2])
    far = torch.minimum(torch.minimum(tf[..., 0], tf[..., 1]), tf[..., 2])
    near = torch.where(torch.isnan(near), -torch.inf, near)
    far = torch.where(torch.isnan(far), torch.inf, far)
    return torch.clamp(near, min=t_min) <= torch.minimum(far, t_max)


def _walk_plain(o, d, chunk: WideChunk, bt, any_hit: bool, t_min: float,
                pops=None, tests=None):
    """Walk one chunk for a batch of rays (B,) whose current best t (or,
    for any hit, bound) is `bt`. Closest hit: updates `bt` in place and
    returns the winning record slot per ray (-1: no better hit in this
    chunk). Any hit: returns the blocked flags. `pops`/`tests` (B,) int64,
    when given, count wide-node pops and triangle tests as the kernel does
    them (an any-hit ray stops at its first hit)."""
    B = o.shape[0]
    dev = o.device
    ix = 1.0 / d
    octant = (
        (d[:, 0] >= 0).long() + 2 * (d[:, 1] >= 0).long() + 4 * (d[:, 2] >= 0).long()
    )
    child = chunk.child.view(-1, 3)
    nbox = chunk.nbox.view(-1, 8)
    stack = torch.zeros((B, chunk.max_stack), dtype=torch.int64, device=dev)
    sp = torch.ones(B, dtype=torch.int64, device=dev)  # root pushed
    slot_best = torch.full((B,), -1, dtype=torch.int64, device=dev)
    blocked = torch.zeros(B, dtype=torch.bool, device=dev)
    shifts = 3 * torch.arange(8, device=dev)
    while True:
        act = torch.nonzero(sp > 0).squeeze(1)
        M = act.numel()
        if M == 0:
            break
        spa = sp[act] - 1
        node = stack[act, spa]
        if pops is not None:
            pops[act] += 1
        pm = chunk.perm[node * 8 + octant[act]].long()
        c8 = (pm[:, None] >> shifts) & 7  # (M, 8) near-first child slots
        rec = child[node[:, None] * 8 + c8].long()  # (M, 8, 3)
        w0, w1, ref = rec[..., 0], rec[..., 1], rec[..., 2]
        cnt = w0 >> 24
        q_lo = torch.stack([w0 & 255, (w0 >> 8) & 255, (w0 >> 16) & 255], -1)
        q_hi = torch.stack([w1 & 255, (w1 >> 8) & 255, (w1 >> 16) & 255], -1)
        nb = nbox[node]
        org, stp = nb[:, None, 0:3], nb[:, None, 3:6]
        lo = org + q_lo.float() * stp
        hi = org + q_hi.float() * stp
        oa, da, bta = o[act], d[act], bt[act]
        need = _slab(oa[:, None], ix[act][:, None], t_min, bta[:, None], lo, hi)

        # Leaf children: every (ray, child, slot) test of this pop, in the
        # kernel's order (ray, near-first child, slot).
        li, lk = torch.nonzero(need & (cnt > 0), as_tuple=True)
        done = torch.zeros(M, dtype=torch.bool, device=dev)
        if li.numel():
            lcnt = cnt[li, lk]
            first = torch.cumsum(lcnt, 0) - lcnt
            pair = torch.repeat_interleave(torch.arange(li.numel(), device=dev), lcnt)
            E = pair.numel()
            pos = torch.arange(E, device=dev)
            slot = ref[li, lk][pair] + (pos - first[pair])
            r = li[pair]  # local ray of each test
            tr = chunk.tri[slot]
            t = triangle_t(oa[r], da[r], tr[:, 0:3], tr[:, 3:6], tr[:, 6:9],
                           t_min, bta[r])
            hit = t < bta[r]
            # First test position (in kernel order) of each local ray.
            big = torch.full((M,), E, dtype=torch.int64, device=dev)
            win = big.scatter_reduce(0, r, torch.where(hit, pos, E), "amin")
            done = win < E
            if any_hit:
                if tests is not None:
                    start = big.scatter_reduce(0, r, pos, "amin")
                    ntest = torch.zeros(M, dtype=torch.int64, device=dev)
                    ntest.index_add_(0, li, lcnt)
                    tests[act] += torch.where(done, win - start + 1, ntest)
                blocked[act[done]] = True
            else:
                if tests is not None:
                    tests.index_add_(0, act[li], lcnt)
                # Strict-< sequential merge == first test reaching the min.
                tmin = torch.full((M,), torch.inf, device=dev).scatter_reduce(
                    0, r, torch.where(hit, t, torch.inf), "amin")
                win = big.scatter_reduce(
                    0, r, torch.where(hit & (t == tmin[r]), pos, E), "amin")
                w = torch.nonzero(win < E).squeeze(1)
                bt[act[w]] = tmin[w]
                slot_best[act[w]] = slot[win[w]]
                done = torch.zeros_like(done)

        # Internal children: pushed far to near, so the nearest pops first.
        push = need & (cnt == 0) & (ref > 0) & ~done[:, None]
        above = push.flip(1).long().cumsum(1).flip(1) - push.long()
        pi, pk = torch.nonzero(push, as_tuple=True)
        stack[act[pi], spa[pi] + above[pi, pk]] = ref[pi, pk]
        sp[act] = torch.where(done, 0, spa + push.sum(1))
    return blocked if any_hit else slot_best


def _check_chunks(chunks) -> None:
    for c in chunks:
        if c.max_stack > WIDE_STACK_CAP:
            raise ValueError(f"max_stack {c.max_stack} > {WIDE_STACK_CAP}")


def closest_wide_plain(o, d, chunks, t_far=None, t_min: float = T_MIN,
                       counts: bool = False):
    """Plain torch closest hit over `chunks`: (t, prim) with prim -1 and
    t = min(t_far, T_MAX) on a miss; with `counts`, also the per-ray
    (pops, tests) of the kernel's walk."""
    _check_chunks(chunks)
    n = o.shape[0]
    dev = o.device
    t = torch.full((n,), T_MAX, dtype=torch.float32, device=dev)
    if t_far is not None:
        t = torch.minimum(t_far.to(torch.float32), t)
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    pops = torch.zeros(n, dtype=torch.int64, device=dev)
    tests = torch.zeros(n, dtype=torch.int64, device=dev)
    for c in chunks:
        for s in range(0, n, _PLAIN_BATCH):
            sl = slice(s, min(n, s + _PLAIN_BATCH))
            bt = t[sl].clone()
            slot = _walk_plain(o[sl], d[sl], c, bt, False, t_min,
                               pops[sl] if counts else None,
                               tests[sl] if counts else None)
            won = slot >= 0
            t[sl] = bt
            prim[sl] = torch.where(won, c.tri_id[slot.clamp(min=0)], prim[sl])
    return (t, prim, pops, tests) if counts else (t, prim)


def anyhit_wide_plain(o, d, chunks, t_far, t_min: float = T_MIN,
                      counts: bool = False):
    """Plain torch any hit over `chunks`: True where a triangle is hit at
    t_min <= t < min(t_far, T_MAX); with `counts`, also (pops, tests)."""
    _check_chunks(chunks)
    n = o.shape[0]
    dev = o.device
    bound = torch.clamp(t_far.to(torch.float32), max=T_MAX)
    blocked = torch.zeros(n, dtype=torch.bool, device=dev)
    pops = torch.zeros(n, dtype=torch.int64, device=dev)
    tests = torch.zeros(n, dtype=torch.int64, device=dev)
    for c in chunks:
        open_ = torch.nonzero(~blocked).squeeze(1)
        for s in range(0, open_.numel(), _PLAIN_BATCH):
            rays = open_[s : s + _PLAIN_BATCH]
            p = torch.zeros(rays.numel(), dtype=torch.int64, device=dev)
            q = torch.zeros_like(p)
            hit = _walk_plain(o[rays], d[rays], c, bound[rays], True, t_min,
                              p if counts else None, q if counts else None)
            blocked[rays] |= hit
            pops[rays] += p
            tests[rays] += q
    return (blocked, pops, tests) if counts else blocked


# --------------------------------------------------------------------------
# CUDA kernels.
# --------------------------------------------------------------------------


def _lib():
    from blink_torch.kernels import _build

    lib = _build.load("wide_walk")
    if not getattr(lib, "_blink_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for fn in (lib.wide_closest, lib.wide_anyhit):
            fn.argtypes = [ptr] * 9 + [i32, f32, ptr]
            fn.restype = i32
        lib._blink_typed = True
    return lib


def _launch(kind: str, o, d, c: WideChunk, out0, out1, t_min: float) -> None:
    """One kernel launch over one chunk. Closest: out0 = t (in/out), out1 =
    prim (in/out). Any hit: out0 = t_far, out1 = blocked (in/out)."""
    n = o.shape[0]
    dev = o.device
    check_arg("o", o, torch.float32, (n, 3), dev)
    check_arg("d", d, torch.float32, (n, 3), dev)
    check_arg("t" if kind == "wide_closest" else "t_far", out0, torch.float32, (n,), dev)
    if kind == "wide_closest":
        check_arg("prim", out1, torch.int32, (n,), dev)
    else:
        check_arg("blocked", out1, torch.bool, (n,), dev)
    nw = c.perm.shape[0] // 8
    check_arg("child", c.child, torch.int32, (nw * 24,), dev)
    check_arg("nbox", c.nbox, torch.float32, (nw * 8,), dev)
    check_arg("perm", c.perm, torch.int32, (nw * 8,), dev)
    check_arg("tri", c.tri, torch.float32, (c.tri.shape[0], 12), dev)
    check_arg("tri_id", c.tri_id, torch.int32, (c.tri.shape[0],), dev)
    if c.tri.data_ptr() % 16:
        raise ValueError("tri must be 16-byte aligned (read as float4)")
    if n == 0:
        return
    fn = getattr(_lib(), kind)
    err = fn(o.data_ptr(), d.data_ptr(), out0.data_ptr(), out1.data_ptr(),
             c.child.data_ptr(), c.nbox.data_ptr(), c.perm.data_ptr(),
             c.tri.data_ptr(), c.tri_id.data_ptr(), n, t_min,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kind} launch failed: cudaError {err}")
    LAUNCHES[kind] += 1


def traverse_closest_wide(o, d, chunks, t_far=None, t_min: float = T_MIN):
    """Closest hit over WideChunks: (t (N,) f32, prim (N,) i32), prim -1 on
    a miss. `t_far` (optional, per ray) bounds the search; t_far = 0 lanes
    cost one root visit per chunk."""
    if not o.is_cuda:
        return closest_wide_plain(o, d, chunks, t_far, t_min)
    _check_chunks(chunks)
    n = o.shape[0]
    t = torch.full((n,), T_MAX, dtype=torch.float32, device=o.device)
    if t_far is not None:
        t = torch.minimum(t_far.to(torch.float32), t).contiguous()
    prim = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    o, d = o.contiguous(), d.contiguous()
    for c in chunks:
        _launch("wide_closest", o, d, c, t, prim, t_min)
    return t, prim


def traverse_anyhit_wide(o, d, chunks, t_far, t_min: float = T_MIN):
    """Any hit over WideChunks: True where a triangle is hit at
    t_min <= t < t_far. Blocked rays skip later chunks."""
    if not o.is_cuda:
        return anyhit_wide_plain(o, d, chunks, t_far, t_min)
    _check_chunks(chunks)
    blocked = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    o, d = o.contiguous(), d.contiguous()
    tf = t_far.to(torch.float32).contiguous()
    for c in chunks:
        _launch("wide_anyhit", o, d, c, tf, blocked, t_min)
    return blocked
