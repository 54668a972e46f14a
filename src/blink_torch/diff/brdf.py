"""Lambertian BRDF: evaluation, pdf and cosine sampling (counterpart of
`blink.diff.brdf`). Differentiable in the albedo; sample directions come
from the counter-based sampler's uniforms."""
from __future__ import annotations

import math

import torch

from blink_torch.core import vec

INV_PI = 1.0 / math.pi


def brdf_eval(albedo, wo, wi, n) -> torch.Tensor:
    """Lambertian f(wo, wi): (..., 3), zero below the horizon."""
    up = (vec.vdot(wi, n) > 0.0) & (vec.vdot(wo, n) > 0.0)
    return torch.where(up[..., None], albedo * INV_PI, 0.0)


def brdf_pdf(wi, n) -> torch.Tensor:
    """Cosine-hemisphere pdf of wi about n."""
    return torch.clamp(vec.vdot(wi, n), min=0.0) * INV_PI


def sample_cosine(n, u1, u2) -> torch.Tensor:
    """Cosine-weighted hemisphere direction about unit normal n, from
    uniforms u1, u2 in [0, 1): (..., 3) unit vectors."""
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    t, b, nn = vec.make_onb(n)
    return vec.from_local(torch.stack([x, y, z], -1), t, b, nn)
