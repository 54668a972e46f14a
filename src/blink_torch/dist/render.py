"""Distributed rendering: image rows split over the ranks, scene replicated,
parameter gradients all-reduced (counterpart of `blink.dist.render`).

  - rank r renders rows [r*rows, (r+1)*rows); rays are keyed by absolute
    pixel id, so the assembled image equals the single-device one bit for
    bit. all_gather assembles it on every rank;
  - each rank holds the whole scene and BVH (scene sharding is
    dist.scene_shard);
  - backward: each rank's pixel loss flows into local parameter gradients,
    then one all_reduce(SUM) per parameter.

Every function here is collective over `group` (default: the default
process group), except dryrun_step, which spawns its own ranks.
"""
from __future__ import annotations

import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from blink_torch.api import (
    _leaf_params,
    _prepare,
    _target,
    build_scene,
    extract_params,
    merge_params,
)
from blink_torch.config import RenderConfig, get_config
from blink_torch.core import sampler
from blink_torch.dist.scene_shard import build_sharded_chunks, intersect_chunks_sharded
from blink_torch.kernels.api import make_backend
from blink_torch.render.api import render_rows
from blink_torch.render.camera import generate_rays
from blink_torch.scene.scene import Scene


def _shard_rows(cfg: RenderConfig, n_shards: int) -> int:
    if cfg.height % n_shards:
        raise ValueError(f"height {cfg.height} must divide by mesh size {n_shards}")
    return cfg.height // n_shards


def dist_render(scene: Scene, cfg: RenderConfig, backend=None, device=None,
                group=None) -> torch.Tensor:
    """The (H, W, 3) image, its rows rendered across the ranks; every rank
    returns the whole image."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    rows = _shard_rows(cfg, n)
    _, scene, backend = _prepare(scene, cfg, device, backend)
    with torch.no_grad():
        block = render_rows(scene, cfg, backend, r * rows, rows).contiguous()
    parts = [torch.empty_like(block) for _ in range(n)]
    dist.all_gather(parts, block, group=group)
    return torch.cat(parts)


def dist_render_grad(scene: Scene, cfg: RenderConfig, target,
                     param_names: tuple[str, ...] = ("albedo", "emission"),
                     backend=None, device=None, group=None):
    """(loss, grads) of pixel MSE against `target` (H, W, 3): each rank
    backpropagates its rows' squared error, then the losses and each
    parameter's gradient are summed over the ranks and divided by H*W*3."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    rows = _shard_rows(cfg, n)
    device, scene, backend = _prepare(scene, cfg, device, backend)
    target = _target(target, device)[r * rows : (r + 1) * rows]
    params = _leaf_params(scene, param_names)
    block = render_rows(merge_params(scene, params), cfg, backend, r * rows, rows)
    sse = torch.sum((block - target) ** 2)
    grads = torch.autograd.grad(sse, list(params.values()), allow_unused=True)
    denom = cfg.height * cfg.width * 3
    out = {}
    for (name, p), g in zip(params.items(), grads):
        g = torch.zeros_like(p) if g is None else g.contiguous()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        out[name] = g / denom
    sse = sse.detach().clone()
    dist.all_reduce(sse, op=dist.ReduceOp.SUM, group=group)
    return sse / denom, out


def dist_fit_step(scene: Scene, cfg: RenderConfig, target, opt, params,
                  backend=None, device=None, group=None) -> torch.Tensor:
    """One data-parallel optimizer step: `params` maps names to the leaf
    tensors that `opt` updates; their gradients come from dist_render_grad.
    Returns the loss before the step."""
    current = {k: v.detach() for k, v in params.items()}
    loss, grads = dist_render_grad(merge_params(scene, current), cfg, target,
                                   tuple(params), backend, device, group)
    opt.zero_grad(set_to_none=False)
    for k, p in params.items():
        p.grad = grads[k].to(p.device)
    opt.step()
    return loss


def _dryrun_rank(rank: int, n: int, store_path: str) -> None:
    """One rank of dryrun_step, on the CPU over gloo."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, n), rank=rank,
                            world_size=n)
    try:
        h = max(16, n)
        while h % n:
            h += 1
        cfg = get_config("pod").override(width=16, height=h, spp=1, max_depth=2,
                                         sponza_tris=2_000, deterministic=True, backend="bvh")
        scene = build_scene(cfg)
        backend = make_backend(cfg.backend, scene)
        target = dist_render(scene, cfg, backend, device="cpu")
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in extract_params(scene, ("albedo", "tri_verts")).items()}
        opt = torch.optim.Adam(list(params.values()), lr=1e-2)
        loss = dist_fit_step(scene, cfg, target, opt, params, backend, device="cpu")
        assert torch.isfinite(loss), loss

        # The scene-sharded walk on the same ranks: each walks its own
        # Morton chunks with the ordered closest-hit walk.
        chunks, meta = build_sharded_chunks(scene.triangles, n, chunk_tris=500)
        o, d, _ = generate_rays(scene.camera, 16, 16, sampler.seed_key(0), 0, False)
        t, prim = intersect_chunks_sharded(o.contiguous(), d, chunks, meta)
        assert bool(torch.isfinite(t).all()) and bool((prim >= -1).all())
    finally:
        dist.destroy_process_group()


def dryrun_step(n_devices: int) -> None:
    """One full sharded training step on tiny shapes over `n_devices` gloo
    ranks on the CPU, spawned here: the `pod` preset at 16 x h, 1 spp,
    depth 2, 2,000 triangles, deterministic, through `bvh` (the path
    integrator with NEE shadow rays, gradients of albedo and tri_verts
    all-reduced, one Adam step, a finite loss), then the scene-sharded
    closest hit over build_sharded_chunks(tris, n_devices, 500) on 16x16
    primary rays. Raises if a rank fails or the ranks take over 600 s."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_dryrun_rank,
                                 args=(n_devices, os.path.join(tmp, "store")),
                                 nprocs=n_devices, join=False, start_method="spawn")
        deadline = time.monotonic() + 600.0
        try:
            # join() returns when one more rank ends, and raises if it failed.
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"dryrun_step: {n_devices} ranks did not finish in 600 s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
