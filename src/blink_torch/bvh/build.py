"""Host-side BVH build helpers (the part of `blink.bvh.build` the wide
BVH needs).
"""
from __future__ import annotations

import numpy as np

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
