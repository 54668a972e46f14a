"""8-wide BVH collapse with quantized child boxes (host-side numpy;
counterpart of `blink.bvh.wide` with `quant=True`, `row_tables=False`).

Collapse rule: greedy surface area. From a binary subtree root, expand
the largest-surface-area internal candidate until 8 children are
collected; a child subtree of at most `wide_leaf` triangles becomes a leaf
child spanning its whole subtree. Per-node octant tables give the
near-first child order for each ray-direction octant, 3 bits per slot.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from blink_torch.bvh.build import EMPTY_BOX
from blink_torch.bvh.types import FlatBVH

WIDTH = 8
#: Stack capacity of the wide walk (<= 1 + 7*depth pushes); checked at
#: build time, and the CUDA kernel's per-ray stack has this size.
WIDE_STACK_CAP = 192
#: Floats per triangle record: v0(3) e1(3) e2(3) and 3 zeros, so that a
#: record is three 16-byte loads.
TRI_COLS = 12
#: Record padding granule, kept from `blink`'s 12-records-per-row layout
#: so that the record tables compare equal array for array.
_TRIS_PER_ROW = 12


@dataclasses.dataclass(frozen=True)
class WideBVH:
    """Host arrays of one quantized 8-wide BVH.

    child: (n_wide*24,) i32 — per slot [w0, w1, w2] with
      w0 = qlo.x | qlo.y<<8 | qlo.z<<16 | cnt<<24, w1 = qhi.x | qhi.y<<8 |
      qhi.z<<16, w2 = ref. cnt > 0: leaf child, triangle slots
      [ref, ref+cnt); cnt == 0 and ref > 0: internal child (wide node
      index); both 0: empty slot.
    nbox: (n_wide*8,) f32 per-node dequantization frames
      [ox oy oz sx sy sz 0 0]: coord = o + q*s, q in [0, 255].
    perm: (n_wide*8,) i32 — per ray-direction octant, the 8 child slots in
      near-first order, 3 bits per position (LSB = nearest).
    tri: (P, 12) f32 triangle records; tri_id: (P,) i32 global triangle
      ids (-1 for padding records, whose zero edges never hit).
    """

    child: np.ndarray
    nbox: np.ndarray
    perm: np.ndarray
    tri: np.ndarray
    tri_id: np.ndarray
    n_wide: int
    max_stack: int


def _quantize_children(child: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(n_wide, 8, 8) f32 child records [lo(3) hi(3) ref cnt] ->
    (childq (n_wide*24,) i32, nbox (n_wide*8,) f32).

    Conservative by construction and by check: q is floor/ceil quantized,
    then nudged until the exact f32 decode `o + q*s`, a multiply and an add
    each rounded (the kernels decode the same way, without a fused
    multiply-add), brackets the true box on every axis. Empty slots encode
    as the far-corner point box q=255."""
    n = child.shape[0]
    lo = child[:, :, 0:3].astype(np.float32)
    hi = child[:, :, 3:6].astype(np.float32)
    ref = child[:, :, 6].astype(np.int64)
    cnt = child[:, :, 7].astype(np.int64)
    assert int(cnt.max(initial=0)) <= 127, "cnt must fit 7 bits (sign-safe)"
    assert int(ref.max(initial=0)) < 2**31, "ref must fit i32"
    filled = ~((cnt == 0) & (ref == 0) & (lo[..., 0] >= 1e29))

    glo = np.where(filled[..., None], lo, np.inf).min(axis=1)
    ghi = np.where(filled[..., None], hi, -np.inf).max(axis=1)
    none = ~filled.any(axis=1)
    glo[none] = 0.0
    ghi[none] = 1.0
    glo = glo.astype(np.float32)
    step = ((ghi - glo) / 255.0).astype(np.float32)
    # Bump step by ulps until origin + 255*step covers ghi in exact f32.
    for _ in range(8):
        bad = (glo + np.float32(255.0) * step) < ghi
        if not bad.any():
            break
        step = np.where(
            bad, np.nextafter(step, np.float32(np.inf)), step
        ).astype(np.float32)
    assert not ((glo + np.float32(255.0) * step) < ghi).any()

    safe = np.where(step > 0, step, np.float32(1.0)).astype(np.float32)
    o3 = glo[:, None, :]
    s3 = safe[:, None, :]
    ql = np.clip(np.floor((lo - o3) / s3), 0, 255).astype(np.float32)
    qh = np.clip(np.ceil((hi - o3) / s3), 0, 255).astype(np.float32)

    def dec(q):
        return (o3 + q * step[:, None, :]).astype(np.float32)

    for _ in range(8):
        low_bad = dec(ql) > lo
        high_bad = dec(qh) < hi
        if not (low_bad[filled].any() or high_bad[filled].any()):
            break
        ql = np.where(low_bad, np.maximum(ql - 1, 0), ql)
        qh = np.where(high_bad, np.minimum(qh + 1, 255), qh)
    assert (dec(ql)[filled] <= lo[filled]).all(), "lo not conservative"
    assert (dec(qh)[filled] >= hi[filled]).all(), "hi not conservative"

    qli = ql.astype(np.int64)
    qhi_ = qh.astype(np.int64)
    qli[~filled] = 255
    qhi_[~filled] = 255
    w0 = qli[..., 0] | (qli[..., 1] << 8) | (qli[..., 2] << 16) | (cnt << 24)
    w1 = qhi_[..., 0] | (qhi_[..., 1] << 8) | (qhi_[..., 2] << 16)
    childq = np.stack([w0, w1, ref], axis=-1).astype(np.int32)  # (n,8,3)
    nbox = np.zeros((n, 8), np.float32)
    nbox[:, 0:3] = glo
    nbox[:, 3:6] = step
    return childq.reshape(n * 24), nbox.reshape(n * 8)


def _sa(lo: np.ndarray, hi: np.ndarray) -> float:
    d = np.maximum(hi - lo, 0.0)
    return float(d[0] * d[1] + d[1] * d[2] + d[0] * d[2])


def build_wide(bvh: FlatBVH, wide_leaf: int = 32) -> WideBVH:
    """Collapse a binary preorder skip-link FlatBVH into a quantized
    WideBVH. Needs the SAH builder's tight preorder leaf-slot packing: any
    subtree then owns the contiguous slot span [csum[i], csum[skip[i]])."""
    lo = np.asarray(bvh.lo, np.float32)
    hi = np.asarray(bvh.hi, np.float32)
    skip = np.asarray(bvh.skip, np.int64)
    count = np.asarray(bvh.count, np.int64)
    n = skip.shape[0]
    node_ids = np.arange(n)
    is_internal = (count == 0) & (skip > node_ids + 1)
    assert int(count.max(initial=0)) <= wide_leaf, (
        "binary leaf_size must be <= wide_leaf"
    )

    # Subtree slot spans: csum[i] = total leaf-slot count before preorder i.
    csum = np.zeros(n + 1, np.int64)
    csum[1:] = np.cumsum(count)
    sub_first = csum[node_ids]
    sub_count = csum[skip] - csum[node_ids]
    first = np.asarray(bvh.first, np.int64)
    leaf_ids = node_ids[count > 0]
    assert np.array_equal(first[leaf_ids], csum[leaf_ids]), (
        "build_wide requires tight preorder leaf-slot packing (SAH trees)"
    )

    # --- greedy SA collapse with adaptive leafing ------------------------
    kids_of: list[list[int]] = []  # wide id -> binary child ids
    wide_ref: list[list[int]] = []  # parallel: wide id per kid, -1 leaf
    queue: list[tuple[int, int]] = [(0, 0)]  # (binary root, wide id)
    next_wide = 1
    qi = 0
    while qi < len(queue):
        b, wid = queue[qi]
        qi += 1
        kids = [b]
        while len(kids) < WIDTH:
            # Split the kid bigger than a wide leaf with the largest
            # surface area; kids that fit a wide leaf stay leaves.
            best, best_sa = -1, -1.0
            for i, k in enumerate(kids):
                if not is_internal[k] or sub_count[k] <= wide_leaf:
                    continue
                s = _sa(lo[k], hi[k])
                if s > best_sa:
                    best, best_sa = i, s
            if best < 0:
                break
            k = kids.pop(best)
            kids.extend((k + 1, int(skip[k + 1])))
        refs = []
        for k in kids:
            if is_internal[k] and not sub_count[k] <= wide_leaf:
                refs.append(next_wide)
                queue.append((k, next_wide))
                next_wide += 1
            else:
                refs.append(-1)  # leaf child: whole-subtree slot span
        while len(kids_of) <= wid:
            kids_of.append([])
            wide_ref.append([])
        kids_of[wid] = kids
        wide_ref[wid] = refs
    n_wide = next_wide

    # --- child records ----------------------------------------------------
    child = np.zeros((n_wide, WIDTH, 8), np.float32)
    child[:, :, 0:6] = EMPTY_BOX
    centers = np.zeros((n_wide, WIDTH, 3), np.float32)
    filled = np.zeros((n_wide, WIDTH), bool)
    for wid in range(n_wide):
        for s, (k, r) in enumerate(zip(kids_of[wid], wide_ref[wid])):
            child[wid, s, 0:3] = lo[k]
            child[wid, s, 3:6] = hi[k]
            if r >= 0:
                child[wid, s, 6] = float(r)
                child[wid, s, 7] = 0.0
            else:
                child[wid, s, 6] = float(sub_first[k])
                child[wid, s, 7] = float(sub_count[k])
            centers[wid, s] = 0.5 * (lo[k] + hi[k])
            filled[wid, s] = True

    # --- per-octant near-first orders --------------------------------------
    oct_bits = np.arange(8)
    signs = np.stack(
        [
            np.where(oct_bits & 1, 1.0, -1.0),
            np.where(oct_bits & 2, 1.0, -1.0),
            np.where(oct_bits & 4, 1.0, -1.0),
        ],
        axis=1,
    ).astype(np.float32)  # (8 octants, 3)
    keys = np.einsum("wsc,oc->wos", centers, signs)  # (n_wide, 8oct, 8slot)
    keys = np.where(filled[:, None, :], keys, np.inf)  # empties last
    order = np.argsort(keys, axis=2, kind="stable")  # near-first slots
    shifts = (3 * np.arange(WIDTH))[None, None, :]
    perm = (order << shifts).sum(axis=2).astype(np.int32)  # (n_wide, 8)

    # --- stack bound from the wide-tree depth --------------------------------
    depth = np.zeros(n_wide, np.int64)
    for wid in range(n_wide):  # parents precede children (BFS ids)
        for r in wide_ref[wid]:
            if r >= 0:
                depth[r] = depth[wid] + 1
    max_stack = int(1 + 7 * (depth.max() + 1)) if n_wide else 1
    if max_stack > WIDE_STACK_CAP:
        raise ValueError(
            f"wide BVH depth {int(depth.max())} needs stack {max_stack} > "
            f"{WIDE_STACK_CAP}"
        )

    # --- triangle records ---------------------------------------------------
    # A leaf visit may read up to wide_leaf slots past its ref in `blink`'s
    # unrolled kernel, so the table extends wide_leaf-1 past the last real
    # slot, rounded up to the 12-record granule.
    need = int(csum[-1]) + wide_leaf - 1
    p = bvh.tri_id.shape[0]
    n_rec = -(-max(p, need) // _TRIS_PER_ROW) * _TRIS_PER_ROW
    tri = np.zeros((n_rec, TRI_COLS), np.float32)
    tri[:p, 0:3] = bvh.tv0
    tri[:p, 3:6] = bvh.te1
    tri[:p, 6:9] = bvh.te2
    tri_id = np.full((n_rec,), -1, np.int32)
    tri_id[:p] = bvh.tri_id

    childq, nbox = _quantize_children(child)
    return WideBVH(
        child=childq,
        nbox=nbox,
        perm=perm.reshape(n_wide * WIDTH),
        tri=tri,
        tri_id=tri_id,
        n_wide=n_wide,
        max_stack=max_stack,
    )
