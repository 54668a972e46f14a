"""Binned-SAH BVH builder (host-side numpy, level-synchronous; counterpart
of `blink.bvh.sah`, array for array).

Level-synchronously, for all active segments (contiguous prim ranges):
  1. per-segment centroid bounds -> widest axis;
  2. NBINS bins along that axis; per-(segment, bin) counts and boxes;
  3. SAH sweep over bins -> best split per segment; a segment becomes a
     leaf if count <= leaf_size;
  4. partition prims with one stable lexsort on (segment, side).
The preorder flatten then walks the recorded binary structure once.
"""
from __future__ import annotations

import numpy as np

from blink_torch.bvh.build import EMPTY_BOX
from blink_torch.bvh.types import FlatBVH

NBINS = 16
#: Depth past which splits are balanced positional halves, bounding depth.
_FORCE_BALANCE_DEPTH = 40


def _sa(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    d = np.maximum(hi - lo, 0.0)
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 0] * d[..., 2]


def _empty_bvh(leaf_size: int) -> FlatBVH:
    far = np.full((1, 3), EMPTY_BOX, np.float32)
    return FlatBVH(
        lo=far, hi=far.copy(),
        skip=np.array([1], np.int32), first=np.array([0], np.int32),
        count=np.array([0], np.int32),
        tv0=np.zeros((leaf_size, 3), np.float32),
        te1=np.zeros((leaf_size, 3), np.float32),
        te2=np.zeros((leaf_size, 3), np.float32),
        tri_id=-np.ones((leaf_size,), np.int32),
        leaf_size=leaf_size,
    )


def build_sah_bvh(verts: np.ndarray, idx: np.ndarray, leaf_size: int = 16) -> FlatBVH:
    """SAH tree over triangles `idx` (T, 3) into the vertex pool `verts`."""
    v = np.asarray(verts, np.float32)
    idx = np.asarray(idx, np.int64)
    T = idx.shape[0]
    K = leaf_size
    if T == 0:
        return _empty_bvh(K)

    p0, p1, p2 = v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]]
    tlo = np.minimum(np.minimum(p0, p1), p2).astype(np.float64)
    thi = np.maximum(np.maximum(p0, p1), p2).astype(np.float64)
    cent = 0.5 * (tlo + thi)

    order = np.arange(T)
    seg_of = np.zeros(T, np.int64)  # segment id per prim position
    # Segment registry (grows as splits happen). A segment is a node-to-be.
    seg_start = [0]
    seg_end = [T]
    seg_parent = [-1]
    seg_leaf = [False]
    seg_depth = [0]
    active = [0]

    while active:
        n_act = len(active)
        act = np.array(active)
        local_of_seg = -np.ones(len(seg_start), np.int64)
        local_of_seg[act] = np.arange(n_act)
        loc = local_of_seg[seg_of]  # (T,) local segment index or -1
        sel = loc >= 0
        locs = loc[sel]
        c = cent[order[sel]]
        lo_p = tlo[order[sel]]
        hi_p = thi[order[sel]]

        # 1. centroid bounds per active segment.
        cb_lo = np.full((n_act, 3), np.inf)
        cb_hi = np.full((n_act, 3), -np.inf)
        np.minimum.at(cb_lo, locs, c)
        np.maximum.at(cb_hi, locs, c)
        ext = cb_hi - cb_lo
        axis = np.argmax(ext, axis=1)
        width = ext[np.arange(n_act), axis]
        degenerate = width <= 1e-12

        # 2. bin prims.
        cax = c[np.arange(c.shape[0]), axis[locs]]
        t0 = cb_lo[locs, axis[locs]]
        w = np.maximum(width[locs], 1e-12)
        b = np.minimum(((cax - t0) / w * NBINS).astype(np.int64), NBINS - 1)
        key = locs * NBINS + b
        counts = np.bincount(key, minlength=n_act * NBINS).reshape(n_act, NBINS)
        bin_lo = np.full((n_act * NBINS, 3), np.inf)
        bin_hi = np.full((n_act * NBINS, 3), -np.inf)
        np.minimum.at(bin_lo, key, lo_p)
        np.maximum.at(bin_hi, key, hi_p)
        bin_lo = bin_lo.reshape(n_act, NBINS, 3)
        bin_hi = bin_hi.reshape(n_act, NBINS, 3)

        # 3. SAH sweep: prefix (left) and suffix (right) boxes/counts.
        pre_lo = np.minimum.accumulate(bin_lo, axis=1)
        pre_hi = np.maximum.accumulate(bin_hi, axis=1)
        suf_lo = np.minimum.accumulate(bin_lo[:, ::-1], axis=1)[:, ::-1]
        suf_hi = np.maximum.accumulate(bin_hi[:, ::-1], axis=1)[:, ::-1]
        pre_n = np.cumsum(counts, axis=1)
        total_n = pre_n[:, -1]
        suf_n = total_n[:, None] - pre_n
        # Split after bin s (s = 0..NBINS-2): left = bins<=s, right = rest.
        sa_l = _sa(pre_lo[:, :-1], pre_hi[:, :-1])
        sa_r = _sa(suf_lo[:, 1:], suf_hi[:, 1:])
        nl = pre_n[:, :-1]
        nr = suf_n[:, :-1]
        cost = sa_l * nl + sa_r * nr
        cost = np.where((nl == 0) | (nr == 0), np.inf, cost)
        best_s = np.argmin(cost, axis=1)
        best_cost = cost[np.arange(n_act), best_s]
        # A leaf must have count <= K: larger segments always split, via
        # SAH when it found a proper cut, else by positional halves.
        make_leaf = total_n <= K
        sah_ok = ~degenerate & np.isfinite(best_cost)

        # 4. partition non-leaf segments.
        splittable = ~make_leaf
        go_right = (b > best_s[locs]) & sah_ok[locs]
        too_deep = np.array([seg_depth[s] for s in act]) >= _FORCE_BALANCE_DEPTH
        need_fb = splittable & (~sah_ok | too_deep)
        if need_fb.any():
            seg_starts_local = np.array([seg_start[s] for s in act])
            pos_in_seg = np.nonzero(sel)[0] - seg_starts_local[locs]
            half = (total_n[locs] + 1) // 2
            go_right = np.where(need_fb[locs], pos_in_seg >= half, go_right)
        go_right &= splittable[locs]
        # stable sort prims of active segments by (segment, side).
        sub = np.lexsort((go_right, locs))
        sel_idx = np.nonzero(sel)[0]
        order[sel_idx] = order[sel_idx[sub]]
        gr_sorted = go_right[sub]
        locs_sorted = locs[sub]

        # Register children.
        new_active = []
        n_left = np.zeros(n_act, np.int64)
        np.add.at(n_left, locs_sorted, ~gr_sorted)
        for a in range(n_act):
            s = act[a]
            if make_leaf[a]:
                seg_leaf[s] = True
                continue
            lchild = len(seg_start)
            st = seg_start[s]
            mid = st + int(n_left[a])
            en = seg_end[s]
            seg_start += [st, mid]
            seg_end += [mid, en]
            seg_parent += [s, s]
            seg_leaf += [False, False]
            seg_depth += [seg_depth[s] + 1, seg_depth[s] + 1]
            new_active += [lchild, lchild + 1]
        # Positions [st, mid) -> left child, [mid, en) -> right child.
        seg_of = seg_of.copy()
        for ch in new_active:
            seg_of[seg_start[ch]:seg_end[ch]] = ch
        active = new_active

    # ---- flatten to preorder (single Python DFS over ~2T/K nodes) ----
    n_segs = len(seg_start)
    children = [[] for _ in range(n_segs)]
    for s in range(1, n_segs):
        children[seg_parent[s]].append(s)
    pre_nodes = []
    stack = [0]
    seg_pre = np.full(n_segs, -1, np.int64)
    while stack:
        s = stack.pop()
        seg_pre[s] = len(pre_nodes)
        pre_nodes.append(s)
        if not seg_leaf[s]:
            l, r = children[s]
            stack.append(r)  # preorder: left first
            stack.append(l)
    n_nodes = len(pre_nodes)
    first = np.zeros(n_nodes, np.int64)
    count = np.zeros(n_nodes, np.int64)

    # skip[p] = p + subtree_size(p), via reversed preorder.
    sub_sz = np.ones(n_nodes, np.int64)
    for p in range(n_nodes - 1, -1, -1):
        s = pre_nodes[p]
        if not seg_leaf[s]:
            l, r = children[s]
            sub_sz[p] = 1 + sub_sz[seg_pre[l]] + sub_sz[seg_pre[r]]
    skip = np.arange(n_nodes) + sub_sz

    # Segment bounds from prim boxes, accumulated up in reversed preorder.
    lo_seg = np.full((n_segs, 3), np.inf)
    hi_seg = np.full((n_segs, 3), -np.inf)
    np.minimum.at(lo_seg, seg_of, tlo[order])
    np.maximum.at(hi_seg, seg_of, thi[order])
    for p in range(n_nodes - 1, -1, -1):
        s = pre_nodes[p]
        if not seg_leaf[s]:
            l, r = children[s]
            lo_seg[s] = np.minimum(lo_seg[l], lo_seg[r])
            hi_seg[s] = np.maximum(hi_seg[l], hi_seg[r])
    lo_n = lo_seg[pre_nodes].astype(np.float32)
    hi_n = hi_seg[pre_nodes].astype(np.float32)
    bad = ~np.isfinite(lo_n).all(axis=1) | ~np.isfinite(hi_n).all(axis=1)
    lo_n[bad] = EMPTY_BOX
    hi_n[bad] = EMPTY_BOX

    # Prim slots: leaves in preorder get consecutive tight blocks, plus a
    # global tail pad of K-1 degenerate slots.
    leaf_pre = [p for p in range(n_nodes) if seg_leaf[pre_nodes[p]]]
    slots = 0
    for p in leaf_pre:
        s = pre_nodes[p]
        first[p] = slots
        count[p] = seg_end[s] - seg_start[s]
        slots += int(count[p])
    P = max(slots + K - 1, 1)
    tv0 = np.zeros((P, 3), np.float32)
    te1 = np.zeros((P, 3), np.float32)
    te2 = np.zeros((P, 3), np.float32)
    tri_id = np.full(P, -1, np.int64)
    sp0, sp1, sp2 = p0[order], p1[order], p2[order]
    for p in leaf_pre:
        s = pre_nodes[p]
        st, en = seg_start[s], seg_end[s]
        base = first[p]
        tv0[base : base + en - st] = sp0[st:en]
        te1[base : base + en - st] = sp1[st:en] - sp0[st:en]
        te2[base : base + en - st] = sp2[st:en] - sp0[st:en]
        tri_id[base : base + en - st] = order[st:en]

    return FlatBVH(
        lo=lo_n,
        hi=hi_n,
        skip=skip.astype(np.int32),
        first=first.astype(np.int32),
        count=count.astype(np.int32),
        tv0=tv0,
        te1=te1,
        te2=te2,
        tri_id=tri_id.astype(np.int32),
        leaf_size=K,
    )
