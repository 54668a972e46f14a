"""Host-side BVH build: Morton-ordered implicit LBVH, flattened to DFS
preorder with skip links, and its refit at fixed topology (counterpart of
`blink.bvh.build`, array for array).

Construction (vectorized numpy):
  1. Triangle centroids -> 30-bit Morton codes -> argsort.
  2. Consecutive runs of `leaf_size` sorted triangles become leaves; the
     leaf count is padded to a power of two L (padding subtrees get the
     far-away EMPTY_BOX point box, which every ray-box test rejects).
  3. The hierarchy is the implicit perfect binary tree over the L leaves;
     bounds are refit bottom-up one level at a time.
  4. Heap (level, pos) -> DFS-preorder index in closed form:
     pre(child) = pre(parent) + 1 (+ subtree size if right child);
     skip(node) = pre(node) + subtree_size(level).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from blink_torch.bvh.types import FlatBVH

#: Empty subtrees are a far-away point box, not inverted bounds: the
#: min/max-swapped slab test reads an inverted box as an infinite one.
EMPTY_BOX = 1e30


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10-bit coords -> 30-bit Morton codes. x: (T,3) in [0,1)."""
    q = np.clip((x * 1024.0).astype(np.uint32), 0, 1023).astype(np.uint64)

    def spread(v: np.ndarray) -> np.ndarray:
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    return (
        (spread(q[:, 0]) << np.uint64(2))
        | (spread(q[:, 1]) << np.uint64(1))
        | spread(q[:, 2])
    )


def build_boxtree(blo: np.ndarray, bhi: np.ndarray, leaf_size: int):
    """Morton-ordered implicit tree over arbitrary boxes blo/bhi (T, 3).
    Returns (lo, hi, skip, first, count, order, heap2pre): the preorder node
    arrays, the Morton permutation of the elements and the heap -> preorder
    map."""
    T = blo.shape[0]
    K = leaf_size
    cent = 0.5 * (blo + bhi)
    scene_lo = cent.min(axis=0)
    scene_hi = cent.max(axis=0)
    norm = (cent - scene_lo) / np.maximum(scene_hi - scene_lo, 1e-12)
    order = np.argsort(_morton3(norm), kind="stable")

    n_leaves = -(-T // K)
    depth = max(int(np.ceil(np.log2(max(n_leaves, 1)))), 0)
    L = 1 << depth
    P = L * K

    def pad(a: np.ndarray, fill: float) -> np.ndarray:
        out = np.full((P,) + a.shape[1:], fill, a.dtype)
        out[:T] = a
        return out

    leaf_lo = pad(blo[order], np.inf).reshape(L, K, 3).min(axis=1)
    leaf_hi = pad(bhi[order], -np.inf).reshape(L, K, 3).max(axis=1)

    lo_levels = [None] * (depth + 1)
    hi_levels = [None] * (depth + 1)
    lo_levels[depth] = leaf_lo
    hi_levels[depth] = leaf_hi
    for l in range(depth - 1, -1, -1):
        lo_levels[l] = lo_levels[l + 1].reshape(-1, 2, 3).min(axis=1)
        hi_levels[l] = hi_levels[l + 1].reshape(-1, 2, 3).max(axis=1)

    n_nodes = 2 * L - 1
    lo = np.empty((n_nodes, 3), np.float32)
    hi = np.empty((n_nodes, 3), np.float32)
    skip = np.empty((n_nodes,), np.int64)
    first = np.zeros((n_nodes,), np.int64)
    count = np.zeros((n_nodes,), np.int64)

    def subtree(l: int) -> int:
        return (1 << (depth - l + 1)) - 1

    leaf_count = np.clip(T - np.arange(L) * K, 0, K)
    heap2pre = []
    for l in range(depth + 1):
        k = np.arange(1 << l)
        pre = np.zeros_like(k)
        for j in range(1, l + 1):
            bit = (k >> (l - j)) & 1
            pre += 1 + bit * subtree(j)
        heap2pre.append(pre)
        lo[pre] = lo_levels[l]
        hi[pre] = hi_levels[l]
        skip[pre] = pre + subtree(l)
        if l == depth:
            first[pre] = k * K
            count[pre] = leaf_count
    empty = (
        ~np.isfinite(lo).all(axis=1)
        | ~np.isfinite(hi).all(axis=1)
        | (hi < lo).any(axis=1)
    )
    lo[empty] = EMPTY_BOX
    hi[empty] = EMPTY_BOX
    return lo, hi, skip, first, count, order, np.concatenate(heap2pre)


def build_flat_bvh(verts: np.ndarray, idx: np.ndarray, leaf_size: int = 16) -> FlatBVH:
    """The Morton BVH of `blink`'s `bvh` backend over triangles `idx` (T, 3)
    into the vertex pool `verts`."""
    v = np.asarray(verts, np.float32)
    idx = np.asarray(idx, np.int64)
    T = idx.shape[0]
    K = leaf_size

    if T == 0:
        far = np.full((1, 3), EMPTY_BOX, np.float32)
        return FlatBVH(
            lo=far, hi=far.copy(),
            skip=np.array([1], np.int32), first=np.array([0], np.int32),
            count=np.array([0], np.int32),
            tv0=np.zeros((K, 3), np.float32),
            te1=np.zeros((K, 3), np.float32),
            te2=np.zeros((K, 3), np.float32),
            tri_id=-np.ones((K,), np.int32),
            leaf_size=K,
        )

    p0, p1, p2 = v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]]
    tlo = np.minimum(np.minimum(p0, p1), p2)
    thi = np.maximum(np.maximum(p0, p1), p2)
    lo, hi, skip, first, count, order, heap2pre = build_boxtree(tlo, thi, K)

    # Reordered, padded triangle SoA.
    P = (skip.shape[0] + 1) // 2 * K

    def pad(a: np.ndarray, fill: float) -> np.ndarray:
        out = np.full((P,) + a.shape[1:], fill, a.dtype)
        out[:T] = a
        return out

    sp0, sp1, sp2 = p0[order], p1[order], p2[order]
    tri_id = np.full((P,), -1, np.int32)
    tri_id[:T] = order
    return FlatBVH(
        lo=lo, hi=hi,
        skip=skip.astype(np.int32), first=first.astype(np.int32),
        count=count.astype(np.int32),
        tv0=pad(sp0, 0.0), te1=pad(sp1 - sp0, 0.0), te2=pad(sp2 - sp0, 0.0),
        tri_id=tri_id,
        heap2pre=heap2pre.astype(np.int32),
        leaf_size=K,
    )


def refit_bvh(bvh: FlatBVH, tris) -> FlatBVH:
    """Bounds refit at fixed topology after the vertices moved (e.g. while
    fitting tri_verts), in torch on the vertices' own device: the reordered
    triangle SoA and leaf boxes from the moved vertices, pooled one heap
    level at a time up to the root, then one scatter through heap2pre.
    Bounds are control structure, not differentiated (the vertices are
    detached). Returns `bvh` with lo, hi, tv0, te1 and te2 as tensors on
    that device; needs build_flat_bvh's heap2pre."""
    if bvh.heap2pre is None:
        raise ValueError("refit_bvh needs build_flat_bvh's heap2pre")
    K = bvh.leaf_size
    verts = tris.verts.detach()
    dev = verts.device
    tri_id = torch.as_tensor(bvh.tri_id, device=dev).long()
    ok = (tri_id >= 0)[:, None]
    i = tris.idx.to(dev).long()[tri_id.clamp(min=0)]
    a, b, c = verts[i[:, 0]], verts[i[:, 1]], verts[i[:, 2]]
    zero = torch.zeros_like(a)
    inf = torch.full_like(a, float("inf"))
    plo = torch.where(ok, torch.minimum(torch.minimum(a, b), c), inf)
    phi = torch.where(ok, torch.maximum(torch.maximum(a, b), c), -inf)

    n_leaves = tri_id.shape[0] // K
    levels_lo = [plo.reshape(n_leaves, K, 3).amin(1)]
    levels_hi = [phi.reshape(n_leaves, K, 3).amax(1)]
    for _ in range(int(np.log2(max(n_leaves, 1)))):
        levels_lo.append(levels_lo[-1].reshape(-1, 2, 3).amin(1))
        levels_hi.append(levels_hi[-1].reshape(-1, 2, 3).amax(1))
    # Heap order is root to leaves; the levels were built leaves to root.
    heap_lo = torch.cat(levels_lo[::-1])
    heap_hi = torch.cat(levels_hi[::-1])
    empty = ~(torch.isfinite(heap_lo).all(1) & torch.isfinite(heap_hi).all(1))
    empty = (empty | (heap_hi < heap_lo).any(1))[:, None]
    heap_lo = torch.where(empty, EMPTY_BOX, heap_lo)
    heap_hi = torch.where(empty, EMPTY_BOX, heap_hi)
    pre = torch.as_tensor(bvh.heap2pre, device=dev).long()
    return dataclasses.replace(
        bvh,
        lo=torch.zeros_like(heap_lo).index_copy_(0, pre, heap_lo),
        hi=torch.zeros_like(heap_hi).index_copy_(0, pre, heap_hi),
        tv0=torch.where(ok, a, zero), te1=torch.where(ok, b - a, zero),
        te2=torch.where(ok, c - a, zero),
    )
