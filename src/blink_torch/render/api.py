"""Rendering pipeline: an image from a Scene + RenderConfig (counterpart of
`blink.render.api`, direct lighting at one sample per loop step).

Rays are generated in tile order: 64x64-pixel tiles, each made of 32x32
blocks, so consecutive rays (the threads of a warp) are neighbouring
pixels and walk the same part of the BVH. The image does not depend on
the order, because every random stream is keyed by absolute pixel and
block id.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from blink_torch.config import RenderConfig
from blink_torch.core import sampler
from blink_torch.render.camera import generate_rays
from blink_torch.render.integrators import INTEGRATORS
from blink_torch.scene.scene import Scene
from blink_torch.scene.shade import pack_tri_shade

#: Pixels per tile (a 64x64 square, else a 32x128 strip).
_TILE_PIXELS = 32 * 128
#: Pixels per block inside a tile (a 32x32 square).
_BLOCK_PIXELS = 8 * 128


def render_rays(o, d, keys, scene: Scene, backend, integrator: str,
                deterministic: bool = False) -> torch.Tensor:
    """Radiance (N, 3) for an arbitrary ray batch."""
    if integrator not in INTEGRATORS:
        raise NotImplementedError(
            f"integrator '{integrator}' is not ported yet (ROADMAP.md queue 1)"
        )
    return INTEGRATORS[integrator](o, d, keys, scene, backend, deterministic)


def _tile_shape(h: int, w: int) -> "tuple[int, int] | None":
    """(th, tw) square tile if the image tiles evenly, else a strip, else
    None (row-major order)."""
    side = math.isqrt(_TILE_PIXELS)
    for th, tw in ((side, side), (32, 128)):
        if h % th == 0 and w % tw == 0:
            return th, tw
    return None


def _block_shape(th: int, tw: int) -> "tuple[int, int] | None":
    """Square 32x32 sub-blocks of a tile, where they divide it."""
    side = math.isqrt(_BLOCK_PIXELS)
    if th * tw % _BLOCK_PIXELS == 0 and th % side == 0 and tw % side == 0:
        return side, side
    return None


def tile_pixel_ids(h: int, w: int, th: int, tw: int, device=None) -> torch.Tensor:
    """Tile-order pixel ids: entry q is the row-major pixel id of the q-th
    ray when rays run tile by tile (and block by block inside a tile)."""
    q = torch.arange(h * w, dtype=torch.int64, device=device)
    per_tile = th * tw
    tile = q // per_tile
    within = q % per_tile
    ntc = w // tw
    r0 = (tile // ntc) * th
    c0 = (tile % ntc) * tw
    blk = _block_shape(th, tw)
    if blk is None:
        r = r0 + within // tw
        c = c0 + within % tw
    else:
        bh, bw = blk
        nbc = tw // bw
        b = within // (bh * bw)
        sub = within % (bh * bw)
        r = r0 + (b // nbc) * bh + sub // bw
        c = c0 + (b % nbc) * bw + sub % bw
    return r * w + c


def untile_image(acc: torch.Tensor, h: int, w: int, th: int, tw: int) -> torch.Tensor:
    """Invert tile_pixel_ids ordering: (h*w, 3) tile order -> (h, w, 3)."""
    blk = _block_shape(th, tw)
    if blk is None:
        v = acc.reshape(h // th, w // tw, th, tw, 3)
        return v.permute(0, 2, 1, 3, 4).reshape(h, w, 3)
    bh, bw = blk
    v = acc.reshape(h // th, w // tw, th // bh, tw // bw, bh, bw, 3)
    return v.permute(0, 2, 4, 1, 3, 5, 6).reshape(h, w, 3)


def render_image(scene: Scene, cfg: RenderConfig, backend) -> torch.Tensor:
    """Accumulated (H, W, 3) radiance image on the scene's device."""
    # Static geometry and no table yet (the brute backend): pack it once, in
    # the graph. With geom_dirty, refine gathers vertices live instead.
    if scene.n_triangles > 0 and backend.shade is None and not scene.geom_dirty:
        backend = dataclasses.replace(backend, shade=pack_tri_shade(scene.triangles))
    h, w = cfg.height, cfg.width
    dev = scene.device
    root = sampler.seed_key(cfg.seed, device=dev)
    tile = _tile_shape(h, w)
    pid = tile_pixel_ids(h, w, *tile, device=dev) if tile is not None else None
    jitter = cfg.jitter and not cfg.deterministic
    acc = torch.zeros((h * w, 3), dtype=torch.float32, device=dev)
    for s in range(cfg.spp):
        o, d, keys = generate_rays(scene.camera, h, w, root, s, jitter, pixel_id=pid)
        acc = acc + render_rays(
            o, d, keys, scene, backend, cfg.integrator, cfg.deterministic
        )
    acc = acc / cfg.spp
    if tile is not None:
        return untile_image(acc, h, w, *tile)
    return acc.reshape(h, w, 3)
