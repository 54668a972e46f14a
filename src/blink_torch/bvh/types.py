"""Flat binary BVH arrays on the host (counterpart of `blink.bvh.types`).

Nodes in DFS preorder with skip links: the successor of a node whose box
is hit is `node+1`, of a missed one `skip[node]`. Triangles are reordered
by leaf and stored as (v0, e1, e2); `tri_id` maps back to the original
triangle index (-1 for padding). `build.refit_bvh` returns one whose lo,
hi, tv0, te1 and te2 are tensors on the moved vertices' device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FlatBVH:
    lo: np.ndarray  # (N, 3) f32
    hi: np.ndarray  # (N, 3) f32
    skip: np.ndarray  # (N,) i32 preorder successor when the box is missed
    first: np.ndarray  # (N,) i32 first primitive slot (leaves; 0 otherwise)
    count: np.ndarray  # (N,) i32 primitives in leaf (0 for internal)
    tv0: np.ndarray  # (P, 3) f32
    te1: np.ndarray  # (P, 3) f32
    te2: np.ndarray  # (P, 3) f32
    tri_id: np.ndarray  # (P,) i32 original triangle index (-1 padding)
    #: Heap (level order, root to leaves) -> preorder map of build_flat_bvh's
    #: implicit tree, for refit_bvh; None for other builds.
    heap2pre: np.ndarray | None = None  # (N,) i32
    leaf_size: int = 4

    @property
    def n_nodes(self) -> int:
        return self.skip.shape[0]
