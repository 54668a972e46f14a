"""Wavefront ray compaction between path bounces (counterpart of
`blink.render.wavefront`).

The path integrator re-sorts its rays after each bounce: dead rays sink to
the tail, and live rays group by direction octant and then by a coarse
cell of their origin, so neighbouring threads of a walk share more of the
BVH. Compaction is a pure permutation: the random streams travel with the
rays (keyed by pixel and block id), so the image is bit-identical with or
without it.
"""
from __future__ import annotations

import torch


def compaction_order(alive, o, d, cells: int = 16) -> torch.Tensor:
    """Permutation (N,) int64 sorting rays by (dead, direction octant,
    origin cell).

    alive: (N,) bool; o, d: (N, 3). Dead rays sort last, in one bucket;
    live rays by the 3-bit octant of d, then by a row-major cell of o on a
    cells^3 grid over the batch's bounding box. The sort is stable."""
    octant = ((d[:, 0] < 0).to(torch.int32) + 2 * (d[:, 1] < 0).to(torch.int32)
              + 4 * (d[:, 2] < 0).to(torch.int32))
    lo = torch.amin(o, dim=0)
    hi = torch.amax(o, dim=0)
    q = torch.clamp(((o - lo) / torch.clamp(hi - lo, min=1e-12) * cells).to(torch.int32),
                    0, cells - 1)
    cell = (q[:, 0] * cells + q[:, 1]) * cells + q[:, 2]
    key = torch.where(alive, octant * cells**3 + cell, 8 * cells**3)
    return torch.sort(key, stable=True).indices
