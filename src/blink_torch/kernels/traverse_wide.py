"""Wide-BVH traversal: closest hit and any hit over a list of 8-wide BVH
chunks (counterpart of the wide part of `blink.kernels.traverse_pallas`:
the host chunk builder, every variant of the `_make_kernel_wide` walk, and
the chunk threading of `traverse_closest_wide`/`traverse_anyhit_wide`).

On a CUDA tensor, `traverse_closest_wide` and `traverse_anyhit_wide`
launch the hand-written kernels of `csrc/wide_walk.cu`, one launch per
chunk, or raise. On a CPU tensor they run the plain torch versions,
`closest_wide_plain` and `anyhit_wide_plain`: a batched walk with a
(rays, max_stack) stack tensor that repeats the kernel's arithmetic and
order of work ray for ray, so the two agree bit for bit.

What the walk computes, per ray and chunk: pop a wide node; read its 8
child boxes (f32, or quantized and decoded as `o + q*s`: a rounded
multiply, then a rounded add); slab-test them against the ray's best t at
the pop (NaN-propagating min/max, then a NaN near becomes -inf and a NaN
far +inf); test the leaf children's triangles under the leaf schedule
(`leaf_mode`: group, row, stream or the timing-only skip; see
`_walk_plain`) with a strict `<` merge; push the internal children so that
the nearest pops first. The child order comes from the ray's own
direction octant. Chunks run in list order (near to far from the
build-time camera) and thread the best t, or the blocked flags. A ray with
t_far = 0 fails every slab test. Every schedule finds the same hits; they
differ in the order of work and in the tables they read.

`blink`'s packet-shape arguments, `rows` and `row_groups`, and its check
`rows <= 32` for the row and stream modes, describe the TPU's 128-lane ray
packets and the row groups whose leaf tests it gates together; here each
ray walks alone and tests only the leaves its own slab tests pass, so they
have no counterpart.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os

import numpy as np
import torch

from blink_torch.bvh.build import _morton3
from blink_torch.bvh.sah import build_sah_bvh
from blink_torch.bvh.sbvh import build_sbvh
from blink_torch.bvh.wide import WIDE_STACK_CAP, WideBVH, build_wide
from blink_torch.kernels._build import check_arg
from blink_torch.kernels.triangle import triangle_t
from blink_torch.kernels.types import T_MAX, T_MIN

#: Triangles per chunk by default (the production backend passes 340k).
CHUNK_TRIS = 120_000
#: Leaf size of the binary SAH trees that build_wide collapses.
SAH_LEAF = 4

#: Rays per step of the plain walk, by device type: bounds its scratch
#: memory (a step's cost is mostly its launches on the card).
_PLAIN_BATCH = {"cpu": 1 << 15, "cuda": 1 << 18}


# --------------------------------------------------------------------------
# Host half: chunked SAH trees collapsed to quantized wide BVHs (numpy).
# --------------------------------------------------------------------------


def _chunked_sah_trees(verts, idx, chunk_tris: int, order_from=None,
                       leaf_size: int = SAH_LEAF, spatial: bool = False):
    """Morton-partition triangles into chunks of `chunk_tris`; one SAH
    FlatBVH (leaves of `leaf_size`) per chunk with global triangle ids,
    an SBVH with `spatial` (bvh.sbvh: references split at bin planes).
    With `order_from` (a point, the camera origin at build time) the chunks
    are sorted near to far from it: the threaded best t then prunes later
    chunks for primary rays."""
    builder = build_sbvh if spatial else build_sah_bvh
    v = np.asarray(verts, np.float32)
    idx = np.asarray(idx, np.int64)
    T = idx.shape[0]
    if T <= chunk_tris:
        return [builder(v, idx, leaf_size)]
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
        bvh = builder(v, idx[sel], leaf_size)
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
    """Pad a WideBVH list to shared shapes (n_wide, records, batches,
    max_stack). Appended nodes, records and batches are unreachable."""
    n_wide = max(c.n_wide for c in chunks)
    n_rec = max(c.tri.shape[0] for c in chunks)
    n_bat = max((c.tbat.shape[0] for c in chunks if c.tbat is not None), default=0)
    stack = max(c.max_stack for c in chunks)

    def pad(a: np.ndarray, n: int) -> np.ndarray:
        return np.concatenate([a, np.zeros((n - a.shape[0],) + a.shape[1:], a.dtype)])

    out = []
    for c in chunks:
        kw = {}
        if c.nbox is not None:
            kw["nbox"] = pad(c.nbox, n_wide * 8)
        if c.bref is not None:
            kw["bref"] = pad(c.bref, n_wide * 8)
            kw["tbat"] = pad(c.tbat, n_bat)
        out.append(dataclasses.replace(
            c, child=pad(c.child, n_wide * (24 if c.quant else 64)),
            perm=pad(c.perm, n_wide * 8), tri=pad(c.tri, n_rec),
            tri_id=pad(c.tri_id, n_rec), n_wide=n_wide, max_stack=stack, **kw,
        ))
    return out


def build_chunked_wide(tris, leaf_size: int = SAH_LEAF, chunk_tris: int = CHUNK_TRIS,
                       wide_leaf: int = 32, split_free: bool = False,
                       block_reads: bool = False, uniform: bool = True,
                       quant: bool = False, row_tables: bool = True,
                       order_from=None, spatial: bool = False) -> list[WideBVH]:
    """Chunked WideBVH list (`blink`'s signature and defaults: f32 child
    boxes with row tables; the production backend asks for quantized boxes
    without them). `leaf_size` is the binary SAH leaf, `wide_leaf` the
    traversal leaf chosen at collapse time (bvh.wide.build_wide). With
    `uniform` and more than one chunk, the chunks are padded to shared
    shapes. `spatial` builds SBVH chunks (bvh.sbvh), whose leaves may share
    a triangle."""
    verts = tris.verts.detach().cpu().numpy()
    idx = tris.idx.cpu().numpy()
    chunks = [
        build_wide(b, wide_leaf=wide_leaf, split_free=split_free,
                   block_reads=block_reads, quant=quant, row_tables=row_tables)
        for b in _chunked_sah_trees(verts, idx, chunk_tris, order_from=order_from,
                                    leaf_size=leaf_size, spatial=spatial)
    ]
    if uniform and len(chunks) > 1:
        chunks = pad_chunks_uniform(chunks)
    return chunks


@dataclasses.dataclass(frozen=True)
class WideChunk:
    """One WideBVH's tables as tensors on the device that walks them
    (bvh.wide.WideBVH has the layouts)."""

    child: torch.Tensor  # quant: (n_wide*24,) i32; else (n_wide*64,) f32
    nbox: torch.Tensor | None  # quant: (n_wide*8,) f32; else None
    perm: torch.Tensor  # (n_wide*8,) i32
    tri: torch.Tensor  # (P, 12) f32
    tri_id: torch.Tensor  # (P,) i32
    max_stack: int
    bref: torch.Tensor | None = None  # (n_wide*8,) i32
    tbat: torch.Tensor | None = None  # (n_batches, 8, 16) f32

    @property
    def n_wide(self) -> int:
        return self.perm.shape[0] // 8

    @property
    def quant(self) -> bool:
        """Quantized child boxes: read from the table's own type, so the
        layout cannot disagree with it."""
        return self.child.dtype == torch.int32

    @staticmethod
    def from_host(w: WideBVH, device) -> "WideChunk":
        def put(a):
            return None if a is None else torch.as_tensor(a).to(device)

        return WideChunk(
            child=put(w.child), nbox=put(w.nbox), perm=put(w.perm), tri=put(w.tri),
            tri_id=put(w.tri_id), max_stack=w.max_stack, bref=put(w.bref),
            tbat=put(w.tbat),
        )


#: The leaf schedules of the wide walk (`blink`'s `leaf_mode`).
LEAF_MODES = ("group", "row", "stream", "skip")


def _default_leaf_mode(chunk, any_hit: bool = False) -> str:
    """The leaf mode when the caller names none, as `blink` resolves it:
    'group', unless BLINK_LEAF_MODE is 'row' or 'stream' and the chunks
    carry row tables (without them it falls back to 'group'), or is
    'group'. The override changes only the speed, never the result."""
    override = os.environ.get("BLINK_LEAF_MODE", "")
    if override in ("row", "stream") and getattr(chunk, "bref", None) is not None:
        return override
    if override == "group":
        return override
    del any_hit
    return "group"


def _resolve_leaf_mode(chunks, leaf_mode, any_hit: bool) -> str:
    if leaf_mode is None:
        return _default_leaf_mode(chunks[0] if chunks else None, any_hit)
    if leaf_mode not in LEAF_MODES:
        raise ValueError(f"leaf_mode must be one of {LEAF_MODES}, got {leaf_mode!r}")
    if leaf_mode in ("row", "stream") and any(c.bref is None for c in chunks):
        raise ValueError(f"leaf_mode='{leaf_mode}' needs chunks built with "
                         "row_tables=True (bref/tbat)")
    return leaf_mode


def launch_name(any_hit: bool, leaf_mode: str, quant: bool) -> str:
    """The LAUNCHES key of one kernel variant: 'wide_closest' and
    'wide_anyhit' for the production variant (group, quantized boxes),
    else e.g. 'wide_closest[row,f32]'."""
    base = "wide_anyhit" if any_hit else "wide_closest"
    if (leaf_mode, quant) == ("group", True):
        return base
    return f"{base}[{leaf_mode},{'quant' if quant else 'f32'}]"


#: Kernel launches since the last reset_launches(), by kernel variant. Each
#: wrapper adds one where it launches its kernel and nowhere else.
LAUNCHES = {launch_name(a, m, q): 0 for a in (False, True) for q in (True, False)
            for m in LEAF_MODES}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def _leaf_tests(oa, da, bta, r, base, cnt, chunk: WideChunk, batched: bool,
                any_hit: bool, t_min: float, ntest=None, seen_leaf=None):
    """The triangle tests of a list of leaves, in the kernel's order: entry
    e is leaf (base[e], cnt[e]) of local ray r[e], entries grouped by ray in
    the order the ray processes them, each leaf in slot order. `batched`:
    base is the leaf's first batch of `tbat` (row and stream modes), else
    its first slot of `tri`. Every test is against the ray's t at entry
    `bta`; a strict-< sequential merge over tests is "the first test
    reaching the minimum", which is what this computes, so the order and
    the batch-entry bounds of the modes give one result.

    Closest hit: (got, t, gid) per local ray, got where a test beat `bta`.
    Any hit: got = blocked. `ntest` (local rays) counts the tests, an
    any-hit ray's up to its first hit; `seen_leaf` marks the slots (or
    batches) read."""
    M = bta.shape[0]
    dev = bta.device
    first = torch.cumsum(cnt, 0) - cnt
    pair = torch.repeat_interleave(torch.arange(r.numel(), device=dev), cnt)
    E = pair.numel()
    pos = torch.arange(E, device=dev)
    q = pos - first[pair]  # index within the leaf
    rr = r[pair]
    if batched:
        row = base[pair] + q // 8
        rec = chunk.tbat[row, q % 8]
    else:
        row = base[pair] + q
        rec = chunk.tri[row]
    if seen_leaf is not None:
        seen_leaf[row] = True
    t = triangle_t(oa[rr], da[rr], rec[:, 0:3], rec[:, 3:6], rec[:, 6:9], t_min, bta[rr])
    hit = t < bta[rr]
    big = torch.full((M,), E, dtype=torch.int64, device=dev)
    win = big.scatter_reduce(0, rr, torch.where(hit, pos, E), "amin")
    got = win < E
    if any_hit:
        if ntest is not None:
            start = big.scatter_reduce(0, rr, pos, "amin")
            total = torch.zeros(M, dtype=torch.int64, device=dev).index_add_(0, r, cnt)
            ntest += torch.where(got, win - start + 1, total)
        return got, None, None
    if ntest is not None:
        ntest.index_add_(0, r, cnt)
    tmin = torch.full((M,), torch.inf, device=dev).scatter_reduce(
        0, rr, torch.where(hit, t, torch.inf), "amin")
    win = big.scatter_reduce(0, rr, torch.where(hit & (t == tmin[rr]), pos, E), "amin")
    w = win.clamp(max=max(E - 1, 0))
    gid = rec[w, 9].long() if batched else chunk.tri_id[row[w]].long()
    return win < E, tmin, gid


def _walk_plain(o, d, chunk: WideChunk, bt, any_hit: bool, t_min: float,
                mode: str = "group", pops=None, tests=None, seen=None):
    """Walk one chunk for a batch of rays (B,) whose current best t (or,
    for any hit, bound) is `bt`, under leaf schedule `mode`. Closest hit:
    updates `bt` in place and returns the global triangle id of the better
    hit per ray (-1: none in this chunk). Any hit: returns the blocked
    flags. `pops`/`tests` (B,) int64, when given, count wide-node pops and
    triangle tests as the kernel does them; `seen` = (node mask, slot or
    batch mask) marks the table rows read.

    Leaf schedules, each the kernel's order of work:
      group  — at a pop, the leaf children that pass, near first, each
               triangle from `tri` in slot order;
      row    — the same leaves, triangles from `tbat` in batches of 8;
      stream — a leaf that passes is recorded, and tested (from `tbat`)
               at the ray's next leaf, or after the walk: an any-hit ray
               stops only once the leaf is tested;
      skip   — no leaf tests (timing only: every ray misses)."""
    B = o.shape[0]
    dev = o.device
    ix = 1.0 / d
    octant = (
        (d[:, 0] >= 0).long() + 2 * (d[:, 1] >= 0).long() + 4 * (d[:, 2] >= 0).long()
    )
    child = chunk.child.view(-1, 3 if chunk.quant else 8)
    batched = mode in ("row", "stream")
    stack = torch.zeros((B, chunk.max_stack), dtype=torch.int64, device=dev)
    sp = torch.ones(B, dtype=torch.int64, device=dev)  # root pushed
    gid_best = torch.full((B,), -1, dtype=torch.int64, device=dev)
    blocked = torch.zeros(B, dtype=torch.bool, device=dev)
    pend_base = torch.zeros(B, dtype=torch.int64, device=dev)
    pend_cnt = torch.zeros(B, dtype=torch.int64, device=dev)
    shifts = 3 * torch.arange(8, device=dev)
    seen_node, seen_leaf = seen if seen is not None else (None, None)

    def leaves(act, r, base, cnt):
        """Test leaves of rays act[r]; a closest hit lowers bt. Returns the
        blocked flags (any hit) of the local rays."""
        ntest = None if tests is None else torch.zeros(act.numel(), dtype=torch.int64,
                                                       device=dev)
        got, tnew, gnew = _leaf_tests(o[act], d[act], bt[act], r, base, cnt, chunk,
                                      batched, any_hit, t_min, ntest, seen_leaf)
        if ntest is not None:
            tests[act] += ntest
        if any_hit:
            blocked[act[got]] = True
            return got
        w = torch.nonzero(got).squeeze(1)
        bt[act[w]] = tnew[w]
        gid_best[act[w]] = gnew[w]
        return torch.zeros_like(got)

    while True:
        act = torch.nonzero(sp > 0).squeeze(1)
        M = act.numel()
        if M == 0:
            break
        spa = sp[act] - 1
        node = stack[act, spa]
        if pops is not None:
            pops[act] += 1
        if seen_node is not None:
            seen_node[node] = True
        pm = chunk.perm[node * 8 + octant[act]].long()
        c8 = (pm[:, None] >> shifts) & 7  # (M, 8) near-first child slots
        rec = child[node[:, None] * 8 + c8]  # (M, 8, 3) i32 or (M, 8, 8) f32
        if chunk.quant:
            rec = rec.long()
            w0, w1, ref = rec[..., 0], rec[..., 1], rec[..., 2]
            cnt = w0 >> 24
            q_lo = torch.stack([w0 & 255, (w0 >> 8) & 255, (w0 >> 16) & 255], -1)
            q_hi = torch.stack([w1 & 255, (w1 >> 8) & 255, (w1 >> 16) & 255], -1)
            nb = chunk.nbox.view(-1, 8)[node]
            org, stp = nb[:, None, 0:3], nb[:, None, 3:6]
            lo = org + q_lo.float() * stp
            hi = org + q_hi.float() * stp
        else:
            lo, hi = rec[..., 0:3], rec[..., 3:6]
            ref, cnt = rec[..., 6].long(), rec[..., 7].long()
        need = _slab(o[act][:, None], ix[act][:, None], t_min, bt[act][:, None], lo, hi)

        # Leaf children that pass, in the kernel's order (ray, near first).
        done = torch.zeros(M, dtype=torch.bool, device=dev)
        li, lk = torch.nonzero(need & (cnt > 0), as_tuple=True)
        if mode != "skip" and li.numel():
            lcnt = cnt[li, lk]
            lbase = (chunk.bref[node[li] * 8 + c8[li, lk]].long() if batched
                     else ref[li, lk])
            if mode == "stream":
                # Each ray tests its pending leaf, then all but the last of
                # this pop's leaves; the last becomes pending.
                last = torch.ones_like(li, dtype=torch.bool)
                last[:-1] = li[1:] != li[:-1]
                has = torch.zeros(M, dtype=torch.bool, device=dev)
                has[li] = True
                pr = torch.nonzero(has & (pend_cnt[act] > 0)).squeeze(1)
                keep = ~last
                key = torch.cat([pr * 16, li[keep] * 16 + 1 + lk[keep]])
                order = torch.argsort(key, stable=True)
                r = torch.cat([pr, li[keep]])[order]
                base = torch.cat([pend_base[act[pr]], lbase[keep]])[order]
                n = torch.cat([pend_cnt[act[pr]], lcnt[keep]])[order]
                pend_base[act[li[last]]] = lbase[last]
                pend_cnt[act[li[last]]] = lcnt[last]
                if r.numel():
                    done = leaves(act, r, base, n)
            else:
                done = leaves(act, li, lbase, lcnt)

        # Internal children: pushed far to near, so the nearest pops first.
        push = need & (cnt == 0) & (ref > 0) & ~done[:, None]
        above = push.flip(1).long().cumsum(1).flip(1) - push.long()
        pi, pk = torch.nonzero(push, as_tuple=True)
        stack[act[pi], spa[pi] + above[pi, pk]] = ref[pi, pk]
        sp[act] = torch.where(done, 0, spa + push.sum(1))

    if mode == "stream":  # the pending leaf of each ray, after its walk
        act = torch.nonzero((pend_cnt > 0) & ~blocked).squeeze(1)
        if act.numel():
            leaves(act, torch.arange(act.numel(), device=dev), pend_base[act], pend_cnt[act])
    return blocked if any_hit else gid_best


def _check_chunks(chunks) -> None:
    for c in chunks:
        if c.max_stack > WIDE_STACK_CAP:
            raise ValueError(f"max_stack {c.max_stack} > {WIDE_STACK_CAP}")


def _seen_masks(c: WideChunk, mode: str, seen):
    """A fresh (node mask, slot or batch mask) for chunk c, appended to
    `seen`; None when `seen` is None."""
    if seen is None:
        return None
    rows = c.tbat.shape[0] if mode in ("row", "stream") else c.tri.shape[0]
    marks = (torch.zeros(c.n_wide, dtype=torch.bool, device=c.perm.device),
             torch.zeros(rows, dtype=torch.bool, device=c.perm.device))
    seen.append(marks)
    return marks


def closest_wide_plain(o, d, chunks, t_far=None, t_min: float = T_MIN,
                       counts: bool = False, leaf_mode: str | None = None, seen=None):
    """Plain torch closest hit over `chunks`: (t, prim) with prim -1 and
    t = min(t_far, T_MAX) on a miss; with `counts`, also the per-ray
    (pops, tests) of the kernel's walk. `leaf_mode` as for
    traverse_closest_wide; `seen` (a list) receives each chunk's marks of
    the nodes and triangle slots (group) or batches (row, stream) read."""
    _check_chunks(chunks)
    mode = _resolve_leaf_mode(chunks, leaf_mode, False)
    n = o.shape[0]
    dev = o.device
    t = torch.full((n,), T_MAX, dtype=torch.float32, device=dev)
    if t_far is not None:
        t = torch.minimum(t_far.to(torch.float32), t)
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    pops = torch.zeros(n, dtype=torch.int64, device=dev)
    tests = torch.zeros(n, dtype=torch.int64, device=dev)
    step = _PLAIN_BATCH[dev.type]
    for c in chunks:
        marks = _seen_masks(c, mode, seen)
        for s in range(0, n, step):
            sl = slice(s, min(n, s + step))
            bt = t[sl].clone()
            gid = _walk_plain(o[sl], d[sl], c, bt, False, t_min, mode,
                              pops[sl] if counts else None,
                              tests[sl] if counts else None, marks)
            t[sl] = bt
            prim[sl] = torch.where(gid >= 0, gid.int(), prim[sl])
    return (t, prim, pops, tests) if counts else (t, prim)


def anyhit_wide_plain(o, d, chunks, t_far, t_min: float = T_MIN,
                      counts: bool = False, leaf_mode: str | None = None, seen=None):
    """Plain torch any hit over `chunks`: True where a triangle is hit at
    t_min <= t < min(t_far, T_MAX); with `counts`, also (pops, tests);
    `leaf_mode` and `seen` as for closest_wide_plain."""
    _check_chunks(chunks)
    mode = _resolve_leaf_mode(chunks, leaf_mode, True)
    n = o.shape[0]
    dev = o.device
    bound = torch.clamp(t_far.to(torch.float32), max=T_MAX)
    blocked = torch.zeros(n, dtype=torch.bool, device=dev)
    pops = torch.zeros(n, dtype=torch.int64, device=dev)
    tests = torch.zeros(n, dtype=torch.int64, device=dev)
    step = _PLAIN_BATCH[dev.type]
    for c in chunks:
        marks = _seen_masks(c, mode, seen)
        open_ = torch.nonzero(~blocked).squeeze(1)
        for s in range(0, open_.numel(), step):
            rays = open_[s : s + step]
            p = torch.zeros(rays.numel(), dtype=torch.int64, device=dev)
            q = torch.zeros_like(p)
            hit = _walk_plain(o[rays], d[rays], c, bound[rays], True, t_min, mode,
                              p if counts else None, q if counts else None, marks)
            blocked[rays] |= hit
            pops[rays] += p
            tests[rays] += q
    return (blocked, pops, tests) if counts else blocked


# --------------------------------------------------------------------------
# CUDA kernels.
# --------------------------------------------------------------------------


#: The -D flag of wide_walk.cu's counting build (walk_counts).
COUNTS_DEFINES = ("WIDE_WALK_COUNTS",)


def typed(lib):
    """`lib`, a loaded build of wide_walk.cu (this tree's or another
    checkout's), with its entry points' argument types set."""
    if not getattr(lib, "_blink_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.wide_walk_launch.argtypes = [i32] * 3 + [ptr] * 12 + [i32, f32, ptr]
        lib.wide_walk_launch.restype = i32
        for k, args in (("wide_walk_attributes", [i32, i32, i32, ptr]),
                        ("wide_walk_set_counters", [ptr, ptr])):
            if hasattr(lib, k):
                getattr(lib, k).argtypes = args
                getattr(lib, k).restype = i32
        lib._blink_typed = True
    return lib


def _lib(defines: tuple[str, ...] = ()):
    """wide_walk.cu's library built with `defines`, typed."""
    from blink_torch.kernels import _build

    return typed(_build.load("wide_walk", defines))


def kernel_symbol(any_hit: bool, mode: str, quant: bool) -> str:
    """The part of a variant's mangled kernel name (in ptxas's report) that
    tells it from the others: wide_group_walk<any_hit, quant, mode>."""
    return (f"15wide_group_walkILb{int(any_hit)}ELb{int(quant)}"
            f"ELi{LEAF_MODES.index(mode)}EE")


def kernel_attributes(any_hit: bool, leaf_mode: str, quant: bool, lib=None) -> dict:
    """What the CUDA runtime reports of one variant's kernel: registers a
    thread, local memory a thread (its stack and any spills), resident
    blocks an SM, threads a block and resident warps an SM. `lib`: another
    build of wide_walk.cu."""
    lib = lib or _lib()
    out = (ctypes.c_int * 4)()
    err = lib.wide_walk_attributes(int(any_hit), int(quant), LEAF_MODES.index(leaf_mode),
                                   ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"wide_walk_attributes failed: cudaError {err}")
    return {"registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2],
            "threads": out[3], "warps_per_sm": out[2] * out[3] // 32}


def _launch(any_hit: bool, mode: str, o, d, c: WideChunk, out0, out1, t_min: float,
            lib=None) -> None:
    """One kernel launch over one chunk. Closest: out0 = t (in/out), out1 =
    prim (in/out). Any hit: out0 = t_far, out1 = blocked (in/out). `lib`:
    another build of wide_walk.cu, whose launches LAUNCHES does not count."""
    n = o.shape[0]
    dev = o.device
    check_arg("o", o, torch.float32, (n, 3), dev)
    check_arg("d", d, torch.float32, (n, 3), dev)
    check_arg("t_far" if any_hit else "t", out0, torch.float32, (n,), dev)
    if any_hit:
        check_arg("blocked", out1, torch.bool, (n,), dev)
    else:
        check_arg("prim", out1, torch.int32, (n,), dev)
    nw = c.n_wide
    if c.quant:
        check_arg("child", c.child, torch.int32, (nw * 24,), dev)
        check_arg("nbox", c.nbox, torch.float32, (nw * 8,), dev)
    else:
        check_arg("child", c.child, torch.float32, (nw * 64,), dev)
    check_arg("perm", c.perm, torch.int32, (nw * 8,), dev)
    check_arg("tri", c.tri, torch.float32, (c.tri.shape[0], 12), dev)
    check_arg("tri_id", c.tri_id, torch.int32, (c.tri.shape[0],), dev)
    aligned = [c.tri, c.child] + ([c.nbox] if c.quant else [])
    if mode in ("row", "stream"):
        check_arg("bref", c.bref, torch.int32, (nw * 8,), dev)
        check_arg("tbat", c.tbat, torch.float32, (c.tbat.shape[0], 8, 16), dev)
        aligned += [c.bref, c.tbat]
    if any(x.data_ptr() % 16 for x in aligned):
        raise ValueError("tri, child, nbox, bref and tbat must be 16-byte aligned "
                         "(read as float4/int4)")
    if n == 0:
        return

    def ptr(x):
        return None if x is None else x.data_ptr()

    err = (lib or _lib()).wide_walk_launch(
        int(any_hit), int(c.quant), LEAF_MODES.index(mode), o.data_ptr(), d.data_ptr(),
        out0.data_ptr(), None if any_hit else out1.data_ptr(),
        out1.data_ptr() if any_hit else None, c.child.data_ptr(), ptr(c.nbox),
        c.perm.data_ptr(), c.tri.data_ptr(), c.tri_id.data_ptr(), ptr(c.bref),
        ptr(c.tbat), n, t_min, torch.cuda.current_stream(dev).cuda_stream)
    name = launch_name(any_hit, mode, c.quant)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    if lib is None:
        LAUNCHES[name] += 1


def traverse_closest_wide(o, d, chunks, t_far=None, t_min: float = T_MIN,
                          leaf_mode: str | None = None):
    """Closest hit over WideChunks: (t (N,) f32, prim (N,) i32), prim -1 on
    a miss. `t_far` (optional, per ray) bounds the search; t_far = 0 lanes
    cost one root visit per chunk. `leaf_mode` (group, row, stream, skip)
    picks the leaf schedule; None resolves through _default_leaf_mode
    (BLINK_LEAF_MODE). row and stream need chunks with row tables."""
    if not o.is_cuda:
        return closest_wide_plain(o, d, chunks, t_far, t_min, leaf_mode=leaf_mode)
    _check_chunks(chunks)
    return _closest_kernel(_resolve_leaf_mode(chunks, leaf_mode, False), o, d, chunks,
                           t_far, t_min)


def _closest_kernel(mode: str, o, d, chunks, t_far, t_min: float, lib=None):
    n = o.shape[0]
    t = torch.full((n,), T_MAX, dtype=torch.float32, device=o.device)
    if t_far is not None:
        t = torch.minimum(t_far.to(torch.float32), t).contiguous()
    prim = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    o, d = o.contiguous(), d.contiguous()
    for c in chunks:
        _launch(False, mode, o, d, c, t, prim, t_min, lib)
    return t, prim


def traverse_anyhit_wide(o, d, chunks, t_far, t_min: float = T_MIN,
                         leaf_mode: str | None = None):
    """Any hit over WideChunks: True where a triangle is hit at
    t_min <= t < t_far. Blocked rays skip later chunks. `leaf_mode` as for
    traverse_closest_wide."""
    if not o.is_cuda:
        return anyhit_wide_plain(o, d, chunks, t_far, t_min, leaf_mode=leaf_mode)
    _check_chunks(chunks)
    return _anyhit_kernel(_resolve_leaf_mode(chunks, leaf_mode, True), o, d, chunks, t_far,
                          t_min)


def _anyhit_kernel(mode: str, o, d, chunks, t_far, t_min: float, lib=None):
    blocked = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    o, d = o.contiguous(), d.contiguous()
    tf = t_far.to(torch.float32).contiguous()
    for c in chunks:
        _launch(True, mode, o, d, c, tf, blocked, t_min, lib)
    return blocked


def walk_counts(any_hit: bool, o, d, chunks, t_far=None, t_min: float = T_MIN,
                leaf_mode: str | None = None, lib=None):
    """The walk of (any_hit, leaf_mode) through wide_walk.cu's counting build
    (`lib`, or this tree's), on CUDA tensors: (output, pops, tests). The
    output is traverse_closest_wide's (t, prim) or traverse_anyhit_wide's
    blocked flags; pops and tests (N,) int64 are each ray's node pops and
    triangle tests summed over the chunks, as closest_wide_plain /
    anyhit_wide_plain(..., counts=True) count them (skip: pops only, no
    tests)."""
    _check_chunks(chunks)
    mode = _resolve_leaf_mode(chunks, leaf_mode, any_hit)
    lib = lib or _lib(COUNTS_DEFINES)
    n, dev = o.shape[0], o.device
    pops = torch.zeros(n, dtype=torch.int64, device=dev)
    tests = torch.zeros_like(pops)
    err = lib.wide_walk_set_counters(pops.data_ptr(), tests.data_ptr())
    if err != 0:
        raise RuntimeError(f"wide_walk_set_counters failed: cudaError {err}")
    try:
        out = (_anyhit_kernel(mode, o, d, chunks, t_far, t_min, lib) if any_hit
               else _closest_kernel(mode, o, d, chunks, t_far, t_min, lib))
        torch.cuda.synchronize(dev)
    finally:
        lib.wide_walk_set_counters(None, None)
    return out, pops, tests
