"""3-vector math over trailing-axis-3 tensors (counterpart of
`blink.core.vec`).

Dot products are written out as `x*x' + y*y' + z*z'`, left to right, so the
plain torch code and the CUDA kernels round in the same order.
"""
from __future__ import annotations

import torch

#: Geometry epsilon used for self-intersection offsets and degenerate guards.
EPS = 1e-6


def vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the trailing axis: (..., 3) -> (...)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], -1)


def length(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(vdot(a, a))


def normalize(a: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Safe normalize: a / max(|a|, eps)."""
    return a / torch.clamp(length(a), min=eps)[..., None]
