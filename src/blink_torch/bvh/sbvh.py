"""Spatial-split BVH builder (SBVH, host-side numpy; counterpart of
`blink.bvh.sbvh`, array for array).

Object-partition SAH trees (bvh.sah) put each triangle in exactly one
leaf, so long or large triangles (the Sponza-class floor and walls) inflate
leaf boxes and overlap sibling subtrees, and every overlap costs a walk
extra node and leaf visits. Spatial splits chop triangle REFERENCES at bin
planes instead: a triangle crossing the plane goes into both children with
its box clipped to each side (chopped boxes, the box-level approximation of
Stich et al.'s exact polygon clip). Every part of every triangle stays
under some leaf whose box contains it, so closest and any-hit walks stay
exact: duplicated references test the same triangle and give the same t;
only equal-t ties between different triangles can resolve otherwise than
on the object-split tree.

Level-synchronous and vectorized like bvh.sah, but membership lives only
in seg_of (ref -> segment id), so duplicating a reference is an append.
Each active segment evaluates the binned object SAH and, when its best
object split's children overlap by more than SBVH_ALPHA of the node's
surface area, a binned spatial split over the node box; the cheaper wins.
Reference growth is capped (MAX_DUP_FRAC); segments past the budget fall
back to object splits. The flatten groups refs by preorder leaf, which
gives the tight preorder slot packing build_wide checks (first == csum).
"""
from __future__ import annotations

import numpy as np

from blink_torch.bvh.build import EMPTY_BOX, build_flat_bvh
from blink_torch.bvh.types import FlatBVH

NBINS = 16
#: consider a spatial split only when the object split's children overlap
#: by more than this fraction of the node's surface area (Stich's alpha).
SBVH_ALPHA = 1e-4
#: total reference budget as a fraction of the triangle count.
MAX_DUP_FRAC = 0.35
_FORCE_BALANCE_DEPTH = 40


def _sa(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    d = np.maximum(hi - lo, 0.0)
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 0] * d[..., 2]


def build_sbvh(verts: np.ndarray, idx: np.ndarray, leaf_size: int = 16) -> FlatBVH:
    """SBVH over triangles `idx` (T, 3) into the vertex pool `verts`;
    `tri_id` repeats where a spatial split duplicated a reference."""
    v = np.asarray(verts, np.float32)
    idx = np.asarray(idx, np.int64)
    T = idx.shape[0]
    K = leaf_size
    if T == 0:
        return build_flat_bvh(v, idx, leaf_size)

    p0a, p1a, p2a = v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]]
    tlo_t = np.minimum(np.minimum(p0a, p1a), p2a).astype(np.float64)
    thi_t = np.maximum(np.maximum(p0a, p1a), p2a).astype(np.float64)

    # Reference set (grows under spatial splits).
    ref_tri = np.arange(T)
    ref_lo = tlo_t.copy()
    ref_hi = thi_t.copy()
    max_refs = int(T * (1.0 + MAX_DUP_FRAC)) + 8

    seg_of = np.zeros(T, np.int64)  # ref -> segment id
    seg_parent = [-1]
    seg_leaf = [False]
    seg_depth = [0]
    active = [0]

    while active:
        n_act = len(active)
        act = np.array(active)
        local_of_seg = -np.ones(len(seg_parent), np.int64)
        local_of_seg[act] = np.arange(n_act)
        loc_all = local_of_seg[seg_of]
        sel_idx = np.nonzero(loc_all >= 0)[0]  # active ref ids
        locs = loc_all[sel_idx]
        lo_p = ref_lo[sel_idx]
        hi_p = ref_hi[sel_idx]
        c = 0.5 * (lo_p + hi_p)
        nsel = sel_idx.shape[0]
        rr_all = np.arange(nsel)

        # 1. centroid + node bounds per active segment.
        cb_lo = np.full((n_act, 3), np.inf)
        cb_hi = np.full((n_act, 3), -np.inf)
        np.minimum.at(cb_lo, locs, c)
        np.maximum.at(cb_hi, locs, c)
        nb_lo = np.full((n_act, 3), np.inf)
        nb_hi = np.full((n_act, 3), -np.inf)
        np.minimum.at(nb_lo, locs, lo_p)
        np.maximum.at(nb_hi, locs, hi_p)
        ext = cb_hi - cb_lo
        axis = np.argmax(ext, axis=1)
        width = ext[np.arange(n_act), axis]
        degenerate = width <= 1e-12

        # 2. object binned SAH (centroid bins — as bvh.sah).
        cax = c[rr_all, axis[locs]]
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
        pre_lo = np.minimum.accumulate(bin_lo, axis=1)
        pre_hi = np.maximum.accumulate(bin_hi, axis=1)
        suf_lo = np.minimum.accumulate(bin_lo[:, ::-1], axis=1)[:, ::-1]
        suf_hi = np.maximum.accumulate(bin_hi[:, ::-1], axis=1)[:, ::-1]
        pre_n = np.cumsum(counts, axis=1)
        total_n = pre_n[:, -1]
        suf_n = total_n[:, None] - pre_n
        sa_l = _sa(pre_lo[:, :-1], pre_hi[:, :-1])
        sa_r = _sa(suf_lo[:, 1:], suf_hi[:, 1:])
        nl = pre_n[:, :-1]
        nr = suf_n[:, :-1]
        obj_cost = sa_l * nl + sa_r * nr
        obj_cost = np.where((nl == 0) | (nr == 0), np.inf, obj_cost)
        obj_s = np.argmin(obj_cost, axis=1)
        ar = np.arange(n_act)
        obj_best = obj_cost[ar, obj_s]
        # Overlap of the best object split's children (the alpha trigger).
        s1 = np.minimum(obj_s + 1, NBINS - 1)
        ov_lo = np.maximum(pre_lo[ar, obj_s], suf_lo[ar, s1])
        ov_hi = np.minimum(pre_hi[ar, obj_s], suf_hi[ar, s1])
        overlap_sa = np.where(
            (ov_hi >= ov_lo).all(axis=1), _sa(ov_lo, ov_hi), 0.0
        )
        node_sa = np.maximum(_sa(nb_lo, nb_hi), 1e-30)

        # 3. spatial binned split over the NODE box on the same axis.
        nax_lo = nb_lo[ar, axis]
        nax_hi = nb_hi[ar, axis]
        nax_w = np.maximum(nax_hi - nax_lo, 1e-12)
        consider = (~degenerate) & (overlap_sa / node_sa > SBVH_ALPHA)
        lo_ax = lo_p[rr_all, axis[locs]]
        hi_ax = hi_p[rr_all, axis[locs]]
        s0 = nax_lo[locs]
        sw = nax_w[locs]
        blo = np.clip(((lo_ax - s0) / sw * NBINS).astype(np.int64), 0, NBINS - 1)
        bhi = np.clip(((hi_ax - s0) / sw * NBINS).astype(np.int64), 0, NBINS - 1)
        ent = np.bincount(
            locs * NBINS + blo, minlength=n_act * NBINS
        ).reshape(n_act, NBINS)
        exi = np.bincount(
            locs * NBINS + bhi, minlength=n_act * NBINS
        ).reshape(n_act, NBINS)
        # Chopped per-bin boxes: ref box clamped to each spanned bin slab.
        sb_lo = np.full((n_act * NBINS, 3), np.inf)
        sb_hi = np.full((n_act * NBINS, 3), -np.inf)
        for j in range(NBINS):
            m = (blo <= j) & (bhi >= j)
            if not m.any():
                continue
            lj = lo_p[m].copy()
            hj = hi_p[m].copy()
            aj = axis[locs[m]]
            s0j = s0[m]
            swj = sw[m]
            rr = np.arange(lj.shape[0])
            lj[rr, aj] = np.maximum(lj[rr, aj], s0j + swj * (j / NBINS))
            hj[rr, aj] = np.minimum(hj[rr, aj], s0j + swj * ((j + 1) / NBINS))
            kj = locs[m] * NBINS + j
            np.minimum.at(sb_lo, kj, lj)
            np.maximum.at(sb_hi, kj, hj)
        sb_lo = sb_lo.reshape(n_act, NBINS, 3)
        sb_hi = sb_hi.reshape(n_act, NBINS, 3)
        spre_lo = np.minimum.accumulate(sb_lo, axis=1)
        spre_hi = np.maximum.accumulate(sb_hi, axis=1)
        ssuf_lo = np.minimum.accumulate(sb_lo[:, ::-1], axis=1)[:, ::-1]
        ssuf_hi = np.maximum.accumulate(sb_hi[:, ::-1], axis=1)[:, ::-1]
        ent_pre = np.cumsum(ent, axis=1)              # refs with blo <= s
        exi_pre = np.cumsum(exi, axis=1)
        snl = ent_pre[:, :-1]                          # left counts
        snr = total_n[:, None] - exi_pre[:, :-1]       # refs with bhi > s
        ssa_l = _sa(spre_lo[:, :-1], spre_hi[:, :-1])
        ssa_r = _sa(ssuf_lo[:, 1:], ssuf_hi[:, 1:])
        sp_cost = ssa_l * snl + ssa_r * snr
        # Progress guard: both children must be strictly smaller than the
        # parent (all-straddle splits would recurse forever).
        bad_sp = (
            (snl == 0) | (snr == 0)
            | (snl >= total_n[:, None]) | (snr >= total_n[:, None])
        )
        sp_cost = np.where(bad_sp | ~consider[:, None], np.inf, sp_cost)
        sp_s = np.argmin(sp_cost, axis=1)
        sp_best = sp_cost[ar, sp_s]
        plane = nax_lo + nax_w * ((sp_s + 1) / NBINS)
        straddle = (blo <= sp_s[locs]) & (bhi > sp_s[locs])
        n_strad = np.zeros(n_act, np.int64)
        np.add.at(n_strad, locs[straddle], 1)

        make_leaf = total_n <= K
        sah_ok = ~degenerate & np.isfinite(obj_best)
        too_deep = (
            np.array([seg_depth[s] for s in act]) >= _FORCE_BALANCE_DEPTH
        )
        use_spatial = (
            ~make_leaf & ~too_deep
            & np.isfinite(sp_best) & (sp_best < obj_best)
        )
        if use_spatial.any():
            # Per-level duplication budget, admitted greedily in segment
            # order.
            budget_left = max_refs - ref_tri.shape[0]
            cum = np.cumsum(np.where(use_spatial, n_strad, 0))
            use_spatial &= cum <= budget_left

        # 4. side assignment.
        splittable = ~make_leaf
        go_right = (b > obj_s[locs]) & sah_ok[locs]
        need_fb = splittable & (~sah_ok | too_deep) & ~use_spatial
        if need_fb.any():
            # Positional-half fallback: deterministic rank within segment.
            ord_l = np.lexsort((sel_idx, locs))
            seg_base = np.concatenate(
                [[0], np.cumsum(np.bincount(locs, minlength=n_act))[:-1]]
            )
            rank = np.empty(nsel, np.int64)
            rank[ord_l] = np.arange(nsel) - seg_base[locs[ord_l]]
            half = (total_n[locs] + 1) // 2
            go_right = np.where(need_fb[locs], rank >= half, go_right)
        usp_l = use_spatial[locs]
        if usp_l.any():
            go_right = np.where(usp_l, (blo > sp_s[locs]) & ~straddle,
                                go_right)
        go_right &= splittable[locs]

        # 5. register children, reassign seg_of, append duplicates.
        lchild_of = np.full(n_act, -1, np.int64)
        rchild_of = np.full(n_act, -1, np.int64)
        new_active = []
        for a in range(n_act):
            s = act[a]
            if make_leaf[a]:
                seg_leaf[s] = True
                continue
            lchild_of[a] = len(seg_parent)
            rchild_of[a] = len(seg_parent) + 1
            seg_parent += [s, s]
            seg_leaf += [False, False]
            seg_depth += [seg_depth[s] + 1, seg_depth[s] + 1]
            new_active += [lchild_of[a], rchild_of[a]]
        split_m = lchild_of[locs] >= 0
        seg_of[sel_idx[split_m]] = np.where(
            go_right[split_m], rchild_of[locs[split_m]],
            lchild_of[locs[split_m]],
        )

        dup_m = usp_l & straddle & split_m
        n_dup = int(dup_m.sum())
        if n_dup:
            dref = sel_idx[dup_m]
            dax = axis[locs[dup_m]]
            dplane = plane[locs[dup_m]]
            rr = np.arange(n_dup)
            # Right copy: lo clamped up to the plane.
            new_lo = ref_lo[dref].copy()
            new_hi = ref_hi[dref].copy()
            new_lo[rr, dax] = np.maximum(new_lo[rr, dax], dplane)
            ref_tri = np.concatenate([ref_tri, ref_tri[dref]])
            ref_lo = np.concatenate([ref_lo, new_lo])
            ref_hi = np.concatenate([ref_hi, new_hi])
            seg_of = np.concatenate([seg_of, rchild_of[locs[dup_m]]])
            # Left copy (in place): hi clamped down to the plane.
            ref_hi[dref, dax] = np.minimum(ref_hi[dref, dax], dplane)

        active = new_active

    # ---- flatten to preorder over segments ----
    n_segs = len(seg_parent)
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
    sub_sz = np.ones(n_nodes, np.int64)
    for p in range(n_nodes - 1, -1, -1):
        s = pre_nodes[p]
        if not seg_leaf[s]:
            l, r = children[s]
            sub_sz[p] = 1 + sub_sz[seg_pre[l]] + sub_sz[seg_pre[r]]
    skip = np.arange(n_nodes) + sub_sz

    # Node bounds from CLIPPED ref boxes (the point of the exercise),
    # accumulated leaf-up.
    lo_seg = np.full((n_segs, 3), np.inf)
    hi_seg = np.full((n_segs, 3), -np.inf)
    np.minimum.at(lo_seg, seg_of, ref_lo)
    np.maximum.at(hi_seg, seg_of, ref_hi)
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

    # Group refs by leaf in PREORDER leaf order -> tight slot packing.
    leaf_rank_of_seg = np.full(n_segs, -1, np.int64)
    leaf_pre = [p for p in range(n_nodes) if seg_leaf[pre_nodes[p]]]
    for rank, p in enumerate(leaf_pre):
        leaf_rank_of_seg[pre_nodes[p]] = rank
    ref_leaf_rank = leaf_rank_of_seg[seg_of]
    assert (ref_leaf_rank >= 0).all(), "ref not in any leaf"
    ref_order = np.lexsort((np.arange(seg_of.shape[0]), ref_leaf_rank))
    leaf_counts = np.bincount(ref_leaf_rank, minlength=len(leaf_pre))
    leaf_first = np.concatenate([[0], np.cumsum(leaf_counts)[:-1]])

    first = np.zeros(n_nodes, np.int64)
    count = np.zeros(n_nodes, np.int64)
    for rank, p in enumerate(leaf_pre):
        first[p] = leaf_first[rank]
        count[p] = leaf_counts[rank]
    assert int(leaf_counts.max(initial=0)) <= K

    slots = int(leaf_counts.sum())
    P = max(slots + K - 1, 1)
    t_ids = ref_tri[ref_order]
    tv0 = np.zeros((P, 3), np.float32)
    te1 = np.zeros((P, 3), np.float32)
    te2 = np.zeros((P, 3), np.float32)
    tri_id = np.full(P, -1, np.int64)
    tv0[:slots] = p0a[t_ids]
    te1[:slots] = p1a[t_ids] - p0a[t_ids]
    te2[:slots] = p2a[t_ids] - p0a[t_ids]
    tri_id[:slots] = t_ids

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
