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


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Reflect direction d about normal n (both (..., 3))."""
    return d - 2.0 * vdot(d, n)[..., None] * n


def make_onb(n: torch.Tensor):
    """Orthonormal basis (t, b, n) from unit normal n.

    Branchless Frisvad construction (the sign is a torch.where), stable as
    n.z -> -1."""
    z = n[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = n[..., 0] * n[..., 1] * a
    t0 = torch.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]], -1
    )
    t1 = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], -1)
    return t0, t1, n


def to_local(v, t, b, n) -> torch.Tensor:
    """World vector v in the (t, b, n) frame."""
    return torch.stack([vdot(v, t), vdot(v, b), vdot(v, n)], -1)


def from_local(v, t, b, n) -> torch.Tensor:
    """Local-frame vector v in world coordinates."""
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
