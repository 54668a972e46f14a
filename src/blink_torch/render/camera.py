"""Pinhole camera ray generation (counterpart of `blink.render.camera`).

Pixel jitter and every later random draw come from counter-based streams
keyed by absolute pixel and block ids, so any ray order renders the same
image.
"""
from __future__ import annotations

import math

import torch

from blink_torch.core import sampler, vec
from blink_torch.scene.scene import Camera


def camera_basis(cam: Camera):
    fwd = vec.normalize(cam.look_at - cam.origin)
    right = vec.normalize(vec.cross(fwd, cam.up))
    up = vec.cross(right, fwd)
    return fwd, right, up


def generate_rays(
    cam: Camera,
    height: int,
    width: int,
    root_key: torch.Tensor,
    sample_idx: int,
    jitter: bool = True,
    pixel_id: torch.Tensor | None = None,
):
    """Primary rays for one spp sample.

    root_key: the (2,) stream root (sampler.seed_key). pixel_id: optional
    (N,) int64 pixel ids in [0, H*W) giving the ray order; default every
    pixel in row-major order.

    Returns (o, d, keys): o/d (N, 3) with d unit length, and (N, 4) int64
    keys — columns 0:2 the per-(pixel, sample) stream, columns 2:4 the
    per-(4x32-pixel block, sample) stream.
    """
    dev = cam.origin.device
    if pixel_id is None:
        pixel_id = torch.arange(height * width, dtype=torch.int64, device=dev)
    n = pixel_id.shape[0]
    pixel_keys = sampler.pixel_key(root_key, pixel_id, sample_idx)
    nbx = -(-width // 32)
    block_id = (pixel_id // width) // 4 * nbx + (pixel_id % width) // 32
    block_keys = sampler.block_key(root_key, block_id, sample_idx)
    keys = torch.cat([pixel_keys, block_keys], dim=-1)
    if jitter:
        uv = sampler.uniform(pixel_keys, 2, dim=0)
        jx, jy = uv[:, 0], uv[:, 1]
    else:
        jx = torch.full((n,), 0.5, dtype=torch.float32, device=dev)
        jy = torch.full((n,), 0.5, dtype=torch.float32, device=dev)

    i = (pixel_id // width).to(torch.float32)  # row
    j = (pixel_id % width).to(torch.float32)  # col
    half_h = torch.tan(cam.fov_deg * (math.pi / 180.0) * 0.5)
    aspect = width / height
    ndc_x = ((j + jx) / width * 2.0 - 1.0) * half_h * aspect
    ndc_y = (1.0 - (i + jy) / height * 2.0) * half_h

    fwd, right, up = camera_basis(cam)
    d = vec.normalize(
        fwd[None, :] + ndc_x[:, None] * right[None, :] + ndc_y[:, None] * up[None, :]
    )
    o = cam.origin.expand(d.shape)
    return o, d, keys
