"""Bilinear texture sampling over the scene's texture atlas (counterpart of
`blink.scene.textures`). Texture id -1 samples a constant 1.0.
"""
from __future__ import annotations

import torch


def _wrap1(x: torch.Tensor) -> torch.Tensor:
    """x % 1.0 with the sign of the divisor, computed as `jnp.remainder`
    does: fmod, then +1 where the remainder is negative."""
    r = torch.fmod(x, 1.0)
    return torch.where(r < 0, r + 1.0, r)


def sample_texture(atlas: torch.Tensor, tex_id: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample.

    atlas: (K, R, R, 3); tex_id: (...,) i32 with -1 = none; uv: (..., 2).
    Returns (..., 3); 1.0 where tex_id < 0 or the atlas is empty.
    """
    ones = torch.ones(uv.shape[:-1] + (3,), dtype=torch.float32, device=uv.device)
    if atlas.shape[0] == 0:
        return ones
    res = atlas.shape[1]
    k = torch.clamp(tex_id, 0, atlas.shape[0] - 1).long()
    # Wrap uv to [0,1), map to texel centers.
    u = _wrap1(uv[..., 0]) * res - 0.5
    v = _wrap1(uv[..., 1]) * res - 0.5
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    u0i = torch.remainder(u0.to(torch.int32), res).long()
    v0i = torch.remainder(v0.to(torch.int32), res).long()
    u1i = torch.remainder(u0i + 1, res)
    v1i = torch.remainder(v0i + 1, res)
    w00 = (1 - fu) * (1 - fv)
    w01 = fu * (1 - fv)
    w10 = (1 - fu) * fv
    w11 = fu * fv
    out = (
        atlas[k, v0i, u0i] * w00
        + atlas[k, v0i, u1i] * w01
        + atlas[k, v1i, u0i] * w10
        + atlas[k, v1i, u1i] * w11
    )
    return torch.where((tex_id >= 0)[..., None], out, ones)
