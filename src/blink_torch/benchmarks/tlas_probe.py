"""The two-level walk against the production flat walk on the instanced
config-4 hall (counterpart of `blink.benchmarks.tlas_probe`).

On the same geometry (scene.builders.sponza_scene_instanced) it measures:
  - the two-level walk (bvh.tlas.traverse_two_level): rays/s and structure
    bytes (each object's BLAS stored once, plus the instance transforms);
  - the production flat walk: make_backend('pallas')'s chunks over the
    flattened world-space triangles through traverse_closest_wide (the
    wide_group_walk kernel on a CUDA device, its plain version on the
    CPU): rays/s and structure bytes;
  - hit parity between the two (hits equal, t within 1e-5).

    python -m blink_torch.benchmarks.tlas_probe [--tris 200000] [--rays 65536]
        [--reps 3] [--device cpu]

It runs on the CUDA device unless --device names another; times are
medians of --reps calls after the parity call, by CUDA events on the
card.
It prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def probe_rays(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """n rays from around the camera down the hall (seeded, as blink's)."""
    rng = np.random.default_rng(3)
    o = np.tile([0.0, 3.0, 38.0], (n, 1)) + rng.uniform(-0.5, 0.5, (n, 3))
    d = rng.standard_normal((n, 3))
    d[:, 2] -= 1.5  # look down the hall
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)  # noqa: E731
    return f32(o), f32(d)


def _nbytes(chunks) -> int:
    return sum(v.numel() * v.element_size() for c in chunks for v in vars(c).values()
               if isinstance(v, torch.Tensor))


def run(n_tris: int = 200_000, n_rays: int = 65_536, reps: int = 3, device=None):
    """(the JSON line's dict, flat (t, prim), two-level (t, prim))."""
    from blink_torch.api import resolve_device
    from blink_torch.benchmarks.harness import _time
    from blink_torch.bvh.tlas import build_two_level, traverse_two_level
    from blink_torch.kernels.api import make_backend
    from blink_torch.kernels.traverse_wide import traverse_closest_wide
    from blink_torch.scene.builders import sponza_scene_instanced

    device = resolve_device(device)
    objects, obj_of_inst, o2w, scene = sponza_scene_instanced(n_tris)
    scene = scene.to(device)
    o, d = probe_rays(n_rays, device)

    t0 = time.perf_counter()
    acc = build_two_level(objects, obj_of_inst, o2w).to(device)
    t1 = time.perf_counter()
    chunks = make_backend("pallas", scene).chunks
    t2 = time.perf_counter()

    def flat_fn():
        return traverse_closest_wide(o, d, chunks)

    def tlas_fn():
        return traverse_two_level(o, d, acc)

    # The parity calls are the warm-up calls of the timings.
    t_fl, p_fl = flat_fn()
    t_tl, p_tl = tlas_fn()
    hit_fl, hit_tl = p_fl >= 0, p_tl >= 0
    parity = bool(torch.equal(hit_fl, hit_tl) and torch.allclose(
        t_fl[hit_fl], t_tl[hit_fl], rtol=1e-5, atol=1e-5))
    dt_flat = _time(flat_fn, warmup=0, iters=reps, device=device)
    dt_tlas = _time(tlas_fn, warmup=0, iters=reps, device=device)
    out = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "n_triangles": int(scene.n_triangles),
        "n_instances": int(len(obj_of_inst)),
        "n_rays": n_rays,
        "parity_exact_hits": parity,
        "prim_equal_fraction": float((p_fl == p_tl).float().mean()),
        "hit_fraction": float(hit_fl.float().mean()),
        "two_level": {"rays_per_s": n_rays / dt_tlas, "structure_mb": acc.nbytes / 1e6,
                      "build_s": t1 - t0},
        "flat": {"name": "chunked-wide", "n_chunks": len(chunks),
                 "rays_per_s": n_rays / dt_flat, "structure_mb": _nbytes(chunks) / 1e6,
                 "build_s": t2 - t1},
        "flat_over_tlas_speed": dt_tlas / dt_flat,
    }
    return out, (t_fl, p_fl), (t_tl, p_tl)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m blink_torch.benchmarks.tlas_probe")
    ap.add_argument("--tris", type=int, default=200_000)
    ap.add_argument("--rays", type=int, default=65_536)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' for the plain walks)")
    args = ap.parse_args(argv)
    out, _, _ = run(args.tris, args.rays, args.reps, args.device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
