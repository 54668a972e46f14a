"""CLI: python -m blink_torch {render,fit} --config <name|file.json> ...
(counterpart of the `render` and `fit` subcommands of `blink.cli`).
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", default="cornell", help="preset name or .json path")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--spp", type=int, default=None)
    p.add_argument("--integrator", default=None, choices=["primary", "direct"])
    p.add_argument("--backend", default=None, choices=["auto", "brute", "wide", "pallas"])
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--deterministic", action="store_true", default=None)
    p.add_argument("--scene", default=None, help="cornell|bunny|sponza")
    p.add_argument("--sponza-tris", dest="sponza_tris", type=int, default=None)
    p.add_argument("--bunny-subdiv", dest="bunny_subdiv", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device; 'cpu' for "
                        "the plain torch path)")


def _load_cfg(args: argparse.Namespace):
    from blink_torch.config import get_config

    return get_config(args.config).override(
        width=args.width,
        height=args.height,
        spp=args.spp,
        integrator=args.integrator,
        backend=args.backend,
        seed=args.seed,
        deterministic=args.deterministic,
        scene=args.scene,
        sponza_tris=args.sponza_tris,
        bunny_subdiv=args.bunny_subdiv,
    )


def cmd_render(args: argparse.Namespace) -> int:
    import numpy as np
    import torch

    from blink_torch.api import build_scene, render, resolve_device
    from blink_torch.kernels.api import make_backend

    cfg = _load_cfg(args)
    device = resolve_device(args.device)
    scene = build_scene(cfg).to(device)
    t0 = time.perf_counter()
    backend = make_backend(cfg.backend, scene)
    t1 = time.perf_counter()
    img = render(scene, cfg, device=device, backend=backend)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t1
    rays = cfg.width * cfg.height * cfg.spp
    # wall_s is the first frame: on a CUDA device it includes the kernels'
    # build at first use.
    print(json.dumps({
        "cmd": "render", "config": args.config, "device": str(device),
        "bvh_s": t1 - t0, "wall_s": dt, "rays": rays, "rays_per_s": rays / dt,
    }))
    if args.out:
        img = img.cpu().numpy()
        if args.out.endswith(".ppm"):
            _save_ppm(args.out, img)
        else:
            np.save(args.out, img)
    return 0


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
    fit_cfg = FitConfig(steps=args.steps, lr=args.lr, log_path=args.log or "")
    _, history = fit(scene0, target, cfg, fit_cfg, device=device, backend=backend)
    print(json.dumps({
        "cmd": "fit", "steps": len(history),
        "loss_first": history[0] if history else None,
        "loss_last": history[-1] if history else None,
    }))
    return 0


def _save_ppm(path: str, img, gamma: float = 2.2) -> None:
    """Binary PPM, tonemapped, for eyeballing renders."""
    import numpy as np

    img8 = (np.clip(img, 0.0, 1.0) ** (1.0 / gamma) * 255.0 + 0.5).astype(np.uint8)
    h, w = img8.shape[:2]
    with open(path, "wb") as fh:
        fh.write(f"P6\n{w} {h}\n255\n".encode())
        fh.write(img8.tobytes())


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="blink_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("render", help="render a config to an image")
    _add_common(pr)
    pr.add_argument("--out", default="", help=".npy or .ppm output path")
    pr.set_defaults(fn=cmd_render)
    pf = sub.add_parser("fit", help="inverse rendering (config 3)")
    _add_common(pf)
    pf.add_argument("--steps", type=int, default=100)
    pf.add_argument("--lr", type=float, default=2e-2)
    pf.add_argument("--target", default="", help=".npy target image (default: self-render)")
    pf.add_argument("--log", default="", help="JSONL per-step log (default: stderr)")
    pf.set_defaults(fn=cmd_fit)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
