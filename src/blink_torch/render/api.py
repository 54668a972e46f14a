"""Rendering pipeline: an image from a Scene + RenderConfig (counterpart of
`blink.render.api`).

Rays are generated in tile order: 64x64-pixel tiles, each made of 32x32
blocks, so consecutive rays (the threads of a warp) are neighbouring
pixels and walk the same part of the BVH. On the wide backend at spp >= 4,
render_image packs sb samples of each pixel next to each other instead
(tile_pixel_ids_spp), sb * H * W rays a batch. The radiance does not
depend on the order, because every random stream is keyed by absolute
pixel, block and sample id; only the f32 sum over samples runs in another
order. Mesh soft silhouettes (cfg.soft_mesh) read each pixel's image
neighbours, so under them the rays run in row-major order, one sample a
batch.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from blink_torch.config import RenderConfig
from blink_torch.core import sampler
from blink_torch.obs.profile import span
from blink_torch.render.camera import generate_rays
from blink_torch.render.integrators import INTEGRATORS, li_path
from blink_torch.scene.scene import Scene
from blink_torch.scene.shade import pack_tri_shade

#: Pixels per tile (a 64x64 square, else a 32x128 strip).
_TILE_PIXELS = 32 * 128
#: Pixels per block inside a tile (a 32x32 square).
_BLOCK_PIXELS = 8 * 128


def render_rays(o, d, keys, scene: Scene, backend, integrator: str, max_depth: int = 4,
                deterministic: bool = False, compact: bool = False,
                soft_sigma: float = 0.0, soft_hw: "tuple[int, int] | None" = None,
                rr_start: int = 0) -> torch.Tensor:
    """Radiance (N, 3) for an arbitrary ray batch.

    soft_sigma > 0 (one-bounce integrators only): the value is unchanged,
    the gradient is diff.soft's soft-silhouette estimator's; with soft_hw,
    the image shape, mesh silhouettes too (rays in row-major pixel order)."""
    if integrator == "path":
        return li_path(o, d, keys, scene, backend, max_depth, deterministic, compact,
                       rr_start=rr_start)
    if integrator not in INTEGRATORS:
        raise KeyError(f"unknown integrator '{integrator}'; "
                       f"choices: {sorted([*INTEGRATORS, 'path'])}")
    if soft_sigma > 0.0:
        from blink_torch.diff.soft import li_direct_soft

        return li_direct_soft(o, d, keys, scene, backend, deterministic, soft_sigma,
                              hw=soft_hw)
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


def untile_image(acc: torch.Tensor, h: int, w: int, th: int, tw: int,
                 blk=None) -> torch.Tensor:
    """Invert tile_pixel_ids ordering: (h*w, 3) tile order -> (h, w, 3).
    `blk` overrides the sub-block shape (the spp-interleaved layout)."""
    blk = _block_shape(th, tw) if blk is None else blk
    if blk is None:
        v = acc.reshape(h // th, w // tw, th, tw, 3)
        return v.permute(0, 2, 1, 3, 4).reshape(h, w, 3)
    bh, bw = blk
    v = acc.reshape(h // th, w // tw, th // bh, tw // bw, bh, bw, 3)
    return v.permute(0, 2, 4, 1, 3, 5, 6).reshape(h, w, 3)


def tile_pixel_ids_spp(h: int, w: int, sb: int, device=None):
    """(pixel_id, sample_idx), each (h*w*sb,) int64, for spp-interleaved
    packets: each 4096-ray tile carries a square patch of 4096/sb pixels x
    sb samples, and each 1024-ray block a square patch of 1024/sb pixels x
    sb samples. Consecutive sb rays are the sb samples of one pixel (fold
    with .reshape(-1, sb, 3).sum(1))."""
    ps = math.isqrt(_TILE_PIXELS // sb)  # tile pixel-patch side
    gs = math.isqrt(_BLOCK_PIXELS // sb)  # block pixel-patch side
    if ps * ps * sb != _TILE_PIXELS or gs * gs * sb != _BLOCK_PIXELS:
        raise ValueError(f"spp block {sb} does not make square patches")
    if h % ps or w % ps:
        raise ValueError(f"image {h}x{w} does not tile by {ps}x{ps} patches")
    q = torch.arange(h * w * sb, dtype=torch.int64, device=device)
    tile = q // _TILE_PIXELS
    within = q % _TILE_PIXELS
    b = within // _BLOCK_PIXELS
    sub = within % _BLOCK_PIXELS
    p = sub // sb
    s = sub % sb
    nbc = ps // gs  # blocks per tile side
    ntc = w // ps
    r = (tile // ntc) * ps + (b // nbc) * gs + p // gs
    c = (tile % ntc) * ps + (b % nbc) * gs + p % gs
    return r * w + c, s


def _spp_block(cfg: RenderConfig, backend, tile) -> int:
    """Samples a pixel packed into one batch: spp_block (4, 16 or 64) when
    it divides spp, else 4 when that does, on the tiled wide backend with
    32 | H and 32 | W; else 1 (the per-sample loop). The tlas backend
    packs as wide does, so that its frames differ from wide's by the walk
    alone."""
    h, w, spp = cfg.height, cfg.width, cfg.spp
    if backend.name not in ("wide", "tlas") or tile is None or h % 32 or w % 32:
        return 1
    want = cfg.spp_block or 4
    if want in (4, 16, 64) and spp % want == 0:
        return want
    return 4 if spp % 4 == 0 else 1


def _with_shade(scene: Scene, backend):
    """Static geometry and no table yet (the brute backend): pack it once,
    in the graph. With geom_dirty, refine gathers vertices live instead."""
    if scene.n_triangles > 0 and backend.shade is None and not scene.geom_dirty:
        backend = dataclasses.replace(backend, shade=pack_tri_shade(scene.triangles))
    return backend


def _radiance(o, d, keys, scene: Scene, cfg: RenderConfig, backend, soft_sigma: float = 0.0,
              soft_hw=None) -> torch.Tensor:
    return render_rays(o, d, keys, scene, backend, cfg.integrator, cfg.max_depth,
                       cfg.deterministic, cfg.compact, soft_sigma=soft_sigma, soft_hw=soft_hw,
                       rr_start=cfg.rr_start)


def render_image(scene: Scene, cfg: RenderConfig, backend) -> torch.Tensor:
    """Accumulated (H, W, 3) radiance image on the scene's device.

    On the tiled wide backend at spp >= 4 the samples go sb at a time
    (_spp_block), H * W * sb rays a batch; else one sample a loop step, as
    render_rows. cfg.soft_sigma > 0 gives soft-silhouette gradients; with
    cfg.soft_mesh too, the rays run in row-major pixel order, one sample a
    step, since mesh silhouettes read each pixel's image neighbours."""
    with span("render"):
        return _image(scene, cfg, backend)


def _image(scene: Scene, cfg: RenderConfig, backend) -> torch.Tensor:
    h, w, spp = cfg.height, cfg.width, cfg.spp
    soft_mesh = cfg.soft_mesh and cfg.soft_sigma > 0
    sb = 1 if soft_mesh else _spp_block(cfg, backend, _tile_shape(h, w))
    if sb == 1:
        return _rows(scene, cfg, backend, 0, h, cfg.soft_sigma, soft_mesh)
    backend = _with_shade(scene, backend)
    dev = scene.device
    root = sampler.seed_key(cfg.seed, device=dev)
    pid, sidx = tile_pixel_ids_spp(h, w, sb, device=dev)
    jitter = cfg.jitter and not cfg.deterministic
    acc = torch.zeros((h * w, 3), dtype=torch.float32, device=dev)
    for bi in range(spp // sb):
        o, d, keys = generate_rays(scene.camera, h, w, root, sidx + bi * sb, jitter,
                                   pixel_id=pid)
        li = _radiance(o, d, keys, scene, cfg, backend, cfg.soft_sigma)
        acc = acc + li.reshape(-1, sb, 3).sum(1)
    ps = math.isqrt(_TILE_PIXELS // sb)
    gs = math.isqrt(_BLOCK_PIXELS // sb)
    return untile_image(acc / spp, h, w, ps, ps, blk=(gs, gs))


def render_rows(scene: Scene, cfg: RenderConfig, backend, row0: int, rows: int,
                soft_sigma: float = 0.0, soft_mesh: bool = False) -> torch.Tensor:
    """Image rows [row0, row0 + rows) of the (H, W) frame, (rows, W, 3), one
    sample a loop step. Rays are keyed by absolute pixel id, so the rows
    equal the same rows of render_image bit for bit wherever render_image
    loops sample by sample too (_spp_block 1: any backend but wide, spp
    not a multiple of 4, or H or W not a multiple of 32); else they differ
    only by the order of the f32 sum over samples.

    The gradient is the hard one unless `soft_sigma` > 0 (cfg.soft_sigma
    is not read here: the dist renders, like blink's, stay hard). With
    `soft_mesh` the rays run in row-major order and the mesh silhouettes
    see the block as the image."""
    with span("render"):
        return _rows(scene, cfg, backend, row0, rows, soft_sigma, soft_mesh)


def _rows(scene: Scene, cfg: RenderConfig, backend, row0: int, rows: int,
          soft_sigma: float, soft_mesh: bool) -> torch.Tensor:
    backend = _with_shade(scene, backend)
    w = cfg.width
    dev = scene.device
    root = sampler.seed_key(cfg.seed, device=dev)
    tile = None if soft_mesh else _tile_shape(rows, w)
    soft_hw = (rows, w) if soft_mesh else None
    if tile is not None:
        pid = row0 * w + tile_pixel_ids(rows, w, *tile, device=dev)
    else:
        pid = torch.arange(row0 * w, (row0 + rows) * w, dtype=torch.int64, device=dev)
    jitter = cfg.jitter and not cfg.deterministic
    acc = torch.zeros((rows * w, 3), dtype=torch.float32, device=dev)
    for s in range(cfg.spp):
        o, d, keys = generate_rays(scene.camera, cfg.height, w, root, s, jitter,
                                   pixel_id=pid)
        acc = acc + _radiance(o, d, keys, scene, cfg, backend, soft_sigma, soft_hw)
    acc = acc / cfg.spp
    if tile is not None:
        return untile_image(acc, rows, w, *tile)
    return acc.reshape(rows, w, 3)
