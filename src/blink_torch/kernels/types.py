"""Hit records: the integer topology the traversal kernels output
(counterpart of `blink.kernels.types`).

Traversal returns which primitive each ray hits; every shading quantity is
re-derived from (ray, prim, scene) by diff.hitrefine.
"""
from __future__ import annotations

import dataclasses

import torch

KIND_NONE = 0
KIND_SPHERE = 1
KIND_TRI = 2

#: t used as the "no hit" sentinel in comparisons.
T_MAX = 1e30
#: minimum ray t, against self-intersection.
T_MIN = 1e-3


@dataclasses.dataclass(frozen=True)
class Hit:
    """Per-ray hit topology. All fields shape (N,)."""

    t: torch.Tensor  # f32, T_MAX on miss
    kind: torch.Tensor  # i32 in {KIND_NONE, KIND_SPHERE, KIND_TRI}
    prim: torch.Tensor  # i32 primitive index within its kind's array
