"""CLI: python -m blink_torch {render,fit,bench} --config <name|file.json> ...
(counterpart of `blink.cli`).
"""
from __future__ import annotations

import argparse
import json
import sys


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", default="cornell", help="preset name or .json path")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--spp", type=int, default=None)
    p.add_argument("--max-depth", dest="max_depth", type=int, default=None)
    p.add_argument("--integrator", default=None, choices=["primary", "direct", "path"])
    p.add_argument("--backend", default=None,
                   choices=["auto", "brute", "bvh", "wide", "pallas", "tlas"],
                   help="tlas: the two-level BVH of a scene with `instances`")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--deterministic", action="store_true", default=None)
    p.add_argument("--scene", default=None, help="cornell|bunny|sponza|obj:<path>")
    p.add_argument("--sponza-tris", dest="sponza_tris", type=int, default=None)
    p.add_argument("--bunny-subdiv", dest="bunny_subdiv", type=int, default=None)
    p.add_argument("--soft-sigma", dest="soft_sigma", type=float, default=None,
                   help="soft-visibility gradient band (0 = hard)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device; 'cpu' for "
                        "the plain torch path)")


def _load_cfg(args: argparse.Namespace):
    from blink_torch.config import get_config

    return get_config(args.config).override(
        width=args.width,
        height=args.height,
        spp=args.spp,
        max_depth=args.max_depth,
        integrator=args.integrator,
        backend=args.backend,
        seed=args.seed,
        deterministic=args.deterministic,
        scene=args.scene,
        sponza_tris=args.sponza_tris,
        bunny_subdiv=args.bunny_subdiv,
        soft_sigma=args.soft_sigma,
    )


def cmd_render(args: argparse.Namespace) -> int:
    if args.dist:
        return _render_dist(args)
    import torch

    from blink_torch.api import build_scene, render, resolve_device
    from blink_torch.kernels.api import make_backend
    from blink_torch.obs.profile import timed, trace

    cfg = _load_cfg(args)
    device = resolve_device(args.device)
    scene = build_scene(cfg).to(device)
    out = {"cmd": "render", "config": args.config, "device": str(device)}
    with timed(out, "bvh_s"):
        backend = make_backend(cfg.backend, scene)
    with trace(args.profile), timed(out, "wall_s"):
        img = render(scene, cfg, device=device, backend=backend)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    rays = cfg.width * cfg.height * cfg.spp
    # wall_s is the first frame: on a CUDA device it includes the kernels'
    # build at first use.
    print(json.dumps({**out, "rays": rays, "rays_per_s": rays / out["wall_s"]}))
    _write_image(args.out, img)
    return 0


def _render_dist(args: argparse.Namespace) -> int:
    """render --dist N: image rows split over N ranks (dist.dist_render).
    N = 1 opens a one-rank group in this process; N > 1 needs a torchrun
    launch of N processes. Rank 0 prints and writes --out."""
    import torch
    import torch.distributed as dist

    from blink_torch.api import build_scene, resolve_device
    from blink_torch.dist import mesh
    from blink_torch.dist.render import dist_render
    from blink_torch.kernels.api import make_backend
    from blink_torch.obs.profile import timed, trace

    n = args.dist
    # gloo for CPU tensors; else the default (NCCL where there is a card).
    pg = "gloo" if args.device and torch.device(args.device).type == "cpu" else None
    if n == 1:
        mesh.init_single_rank(pg)
    elif not mesh.init_distributed(pg):
        raise ValueError(f"--dist {n} needs a torchrun launch of {n} processes "
                         "(torchrun --nproc-per-node N -m blink_torch render ...)")
    try:
        if dist.get_world_size() != n:
            raise ValueError(f"--dist {n} under a world of {dist.get_world_size()} ranks")
        cfg = _load_cfg(args)
        device = resolve_device(args.device)
        scene = build_scene(cfg).to(device)
        backend = make_backend(cfg.backend, scene)
        out = {"cmd": "render", "config": args.config, "device": str(device), "dist": n}
        with trace(args.profile), timed(out, "wall_s"):
            img = dist_render(scene, cfg, backend=backend, device=device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        if dist.get_rank() == 0:
            rays = cfg.width * cfg.height * cfg.spp
            print(json.dumps({**out, "rays": rays, "rays_per_s": rays / out["wall_s"]}))
            _write_image(args.out, img)
    finally:
        mesh.close()
    return 0


def _write_image(path: str, img) -> None:
    from blink_torch.scene.io import save_image_npy, save_image_ppm

    if path:
        (save_image_ppm if path.endswith(".ppm") else save_image_npy)(path, img)


def cmd_fit(args: argparse.Namespace) -> int:
    import numpy as np
    import torch

    from blink_torch.api import build_scene, fit, render, resolve_device
    from blink_torch.config import FitConfig
    from blink_torch.kernels.api import make_backend

    cfg = _load_cfg(args)
    device = resolve_device(args.device)
    scene = build_scene(cfg).to(device)
    backend = make_backend(cfg.backend, scene)
    if args.target:
        target = torch.from_numpy(np.load(args.target).astype(np.float32)).to(device)
    else:
        target = render(scene, cfg, device=device, backend=backend)
    # Perturb the sphere centres, then recover them. The noise comes from a
    # torch.Generator, so it is not the numbers blink draws with jax.random.
    scene0 = scene
    if scene.n_spheres > 0:
        gen = torch.Generator().manual_seed(cfg.seed + 1)
        noise = 0.15 * torch.randn(scene.spheres.center.shape, generator=gen)
        center = scene.spheres.center + noise.to(device)
        scene0 = scene.replace(spheres=scene.spheres.replace(center=center))
    fit_cfg = FitConfig(steps=args.steps, lr=args.lr, ckpt_path=args.ckpt, log_path=args.log,
                        tb_dir=args.tb)
    _, history = fit(scene0, target, cfg, fit_cfg, device=device, backend=backend,
                     resume_from=args.resume)
    print(json.dumps({
        "cmd": "fit", "steps": len(history),
        "loss_first": history[0] if history else None,
        "loss_last": history[-1] if history else None,
    }))
    return 0


def cmd_bench(args: argparse.Namespace) -> int:
    from blink_torch.benchmarks.harness import run_bench

    print(json.dumps(run_bench(args.config, quick=args.quick, device=args.device,
                               backend=args.backend)))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="blink_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("render", help="render a config to an image")
    _add_common(pr)
    pr.add_argument("--out", default="", help=".npy or .ppm output path")
    pr.add_argument("--dist", type=int, default=0, metavar="N",
                    help="split image rows over N ranks (N > 1: launch with torchrun)")
    pr.add_argument("--profile", default="",
                    help="write a torch.profiler trace of the render to this logdir")
    pr.set_defaults(fn=cmd_render)
    pf = sub.add_parser("fit", help="inverse rendering (config 3)")
    _add_common(pf)
    pf.add_argument("--steps", type=int, default=100)
    pf.add_argument("--lr", type=float, default=2e-2)
    pf.add_argument("--target", default="", help=".npy target image (default: self-render)")
    pf.add_argument("--ckpt", default="", help="safetensors checkpoint path (every 50 steps)")
    pf.add_argument("--resume", default="", help="checkpoint to continue from")
    pf.add_argument("--log", default="", help="JSONL per-step log (default: stderr)")
    pf.add_argument("--tb", default="", help="tensorboard logdir")
    pf.set_defaults(fn=cmd_fit)
    pb = sub.add_parser("bench", help="benchmark one config (benchmarks.harness.run_bench)")
    pb.add_argument("--config", default="sponza")
    pb.add_argument("--quick", action="store_true", help="cap size, spp and triangles")
    pb.add_argument("--backend", default=None,
                    choices=["auto", "brute", "bvh", "wide", "pallas", "tlas"],
                    help="override the config's backend (Cornell's auto is brute: no kernel)")
    pb.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' for the plain "
                         "torch path)")
    pb.set_defaults(fn=cmd_bench)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
