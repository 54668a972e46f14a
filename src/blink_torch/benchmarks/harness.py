"""Benchmark harness (counterpart of `blink.benchmarks.harness`).

Rays/s of the forward and forward+backward passes of a config, the
headline primary traversal of the 1M-triangle scene, and a roofline of
that traversal against one H100's HBM and FP32 rates. Every timing runs
on the device it is given: a CUDA device (the default, the only place
speed is measured) or an explicit `device="cpu"`, on which the same
backends run their plain torch walks (tests only). There is no fallback:
without a CUDA device and without `device="cpu"`, each function raises.
`benchmarks/headline.py` prints the headline as one JSON line.
"""
from __future__ import annotations

import time
from typing import Any, Callable

import torch

from blink_torch.api import build_scene, render, render_grad, resolve_device
from blink_torch.config import get_config
from blink_torch.kernels.api import make_backend

#: One H100 SXM's peak rates (NVIDIA's data sheet): HBM3 in GB/s, and FP32
#: outside the tensor cores in TFLOP/s.
HBM_GBPS_NOMINAL = 3350.0
FP32_TFLOPS = 67.0
#: The quantized 8-wide walk's traffic (bvh/wide.py, kernels/traverse_wide.py):
#: a node pop reads 8 child records of 12 B, the node's dequantization frame
#: (32 B) and its octant orders (32 B); a triangle test reads v0, e1 and e2
#: (36 B of the 48 B record); a ray reads o and d and writes t and prim.
NODE_BYTES = 8 * 12 + 32 + 32
TRI_BYTES = 36
RAY_BYTES = 24 + 8
#: FP32 operations: 8 slab tests of 20 a pop, 35 a Möller–Trumbore test.
NODE_OPS = 8 * 20
TRI_OPS = 35


def _first_tensor(r) -> torch.Tensor:
    while not torch.is_tensor(r):
        r = next(iter(r.values())) if isinstance(r, dict) else r[0]
    return r


def _checksum(r) -> torch.Tensor:
    """The sum of the first output tensor, on its device: reading it on the
    host (`.item()`) proves the call really finished."""
    return _first_tensor(r).detach().float().sum()


def _host_checksum(r) -> float:
    return float(_checksum(r).item())


def _elapsed_s(body: Callable[[], torch.Tensor], device: torch.device) -> float:
    """Seconds of body(), which returns a checksum tensor that is read on
    the host before the clock stops: CUDA events around it on a CUDA
    device, the host's perf_counter on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        float(body().item())
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    s = body()
    end.record()
    float(s.item())
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _time(fn, *args, warmup: int = 1, iters: int = 3, device=None) -> float:
    """Median seconds of one call of fn(*args) after warmup, each call
    timed alone up to its checksum's read: single-call LATENCY, host
    launch gaps included. Use _time_sustained for throughput."""
    device = resolve_device(device)
    for _ in range(warmup):
        _host_checksum(fn(*args))
    times = sorted(_elapsed_s(lambda: _checksum(fn(*args)), device) for _ in range(iters))
    return times[len(times) // 2]


def _time_sustained(fn, *args, warmup: int = 1, reps: int = 5, batches: int = 3,
                    device=None) -> float:
    """Median per-call seconds over batches of `reps` calls issued back to
    back with one checksum read at the end, so the device runs while the
    host launches: the steady state of a render or fitting loop."""
    device = resolve_device(device)
    for _ in range(warmup):
        _host_checksum(fn(*args))

    def batch():
        r = None
        for _ in range(reps):
            r = fn(*args)
        return _checksum(r)

    per_call = sorted(_elapsed_s(batch, device) / reps for _ in range(batches))
    return per_call[len(per_call) // 2]


def measure_hbm_gbps(device=None, nbytes: int = 1 << 30) -> float:
    """The device's copy bandwidth in GB/s (bytes read plus bytes written)
    of a device-to-device copy of `nbytes` (1 GiB by default), by
    _time_sustained."""
    device = resolve_device(device)
    src = torch.ones(nbytes // 4, dtype=torch.float32, device=device)
    dst = torch.empty_like(src)
    dt = _time_sustained(lambda: dst.copy_(src)[:1], device=device)
    return 2 * src.numel() * 4 / dt / 1e9


def tile_rays(o, d, h: int, w: int):
    """Rays of an h x w image in the tile order render_image walks them
    (render.api.tile_pixel_ids), or as they are if the image does not
    tile."""
    from blink_torch.render.api import _tile_shape, tile_pixel_ids

    tile = _tile_shape(h, w)
    if tile is None:
        return o, d
    pid = tile_pixel_ids(h, w, *tile, device=o.device)
    return o[pid], d[pid]


def primary_rays(scene, height: int, width: int, device):
    """Pixel-centre camera rays of a height x width image, in tile order,
    contiguous."""
    from blink_torch.core import sampler
    from blink_torch.render.camera import generate_rays

    o, d, _ = generate_rays(scene.camera, height, width, sampler.seed_key(0, device), 0, False)
    return tuple(x.contiguous() for x in tile_rays(o, d, height, width))


def walk_work(o, d, chunks, device) -> tuple[float, float]:
    """Node pops and triangle tests a ray of the closest-hit wide walk on
    these rays: the counting build on a CUDA device, the plain walk's
    counts on the CPU."""
    from blink_torch.kernels import traverse_wide as tw

    if device.type == "cuda":
        _, pops, tests = tw.walk_counts(False, o, d, chunks)
    else:
        _, _, pops, tests = tw.closest_wide_plain(o, d, chunks, counts=True)
    n = o.shape[0]
    return float(pops.sum()) / n, float(tests.sum()) / n


def bench_primary_traversal(scene, size: int = 1024, device=None,
                            backend=None) -> dict[str, Any]:
    """HEADLINE: primary rays/s of the closest-hit walk over the scene's
    production BVH (make_backend('pallas'): the chunks render_image walks,
    the CUDA kernels on a CUDA device), `size` x `size` pixel-centre rays
    in tile order. Also the walk's pops and triangle tests a ray
    (walk_work), for roofline."""
    from blink_torch.kernels import traverse_wide as tw

    device = resolve_device(device)
    scene = scene.to(device)
    if backend is None:
        backend = make_backend("pallas", scene)
    o, d = primary_rays(scene, size, size, device)
    chunks = backend.chunks

    def f():
        return tw.traverse_closest_wide(o, d, chunks)

    dt = _time_sustained(f, device=device)
    dt_blocked = _time(f, device=device)
    _, prim = f()
    pops, tests = walk_work(o, d, chunks, device)
    n = size * size
    return {
        "wall_s": dt,
        "rays": n,
        "rays_per_s": n / dt,
        "latency_wall_s": dt_blocked,
        "launch_overhead_s": dt_blocked - dt,
        "hit_fraction": float((prim >= 0).float().mean()),
        "n_chunks": len(chunks),
        "pops_per_ray": pops,
        "tests_per_ray": tests,
    }


def bench_render(scene, cfg, backend=None, device=None) -> dict[str, Any]:
    """Forward rays/s of one config through api.render."""
    device = resolve_device(device)
    scene = scene.to(device)
    if backend is None:
        backend = make_backend(cfg.backend, scene)
    dt = _time(lambda: render(scene, cfg, device=device, backend=backend), device=device)
    # Primary rays only; the path integrator's bounces trace more, reported
    # as traced_rays_per_s.
    rays = cfg.width * cfg.height * cfg.spp
    depth = cfg.max_depth if cfg.integrator == "path" else 1
    return {
        "wall_s": dt,
        "rays": rays,
        "rays_per_s": rays / dt,
        "traced_rays_per_s": rays * depth / dt,
    }


def bench_render_grad(scene, cfg, param_names=("albedo",), backend=None,
                      device=None) -> dict[str, Any]:
    """Forward+backward rays/s of one config: render_grad of pixel MSE
    against a zero target."""
    device = resolve_device(device)
    scene = scene.to(device)
    if backend is None:
        backend = make_backend(cfg.backend, scene)
    target = torch.zeros((cfg.height, cfg.width, 3), device=device)
    dt = _time(lambda: render_grad(scene, cfg, target, tuple(param_names), device=device,
                                   backend=backend), device=device)
    rays = cfg.width * cfg.height * cfg.spp
    return {"wall_s": dt, "rays": rays, "rays_per_s_fwd_bwd": rays / dt}


def roofline(n_tris: int, rays_per_s: float, hbm_gbps: float = HBM_GBPS_NOMINAL,
             hbm_gbps_measured: float | None = None, *, pops_per_ray: float,
             tests_per_ray: float) -> dict[str, Any]:
    """Speed of light of a walk that moves every byte of every pop and
    test from HBM, with no cache reuse (`bytes_model`, blink's model
    too): the bytes a ray implies at the measured rate against its pops'
    and tests' bytes, and the rays/s the nominal and the measured
    (`hbm_gbps_measured`, measure_hbm_gbps) HBM rates and the FP32 peak
    would allow. `pops_per_ray` and `tests_per_ray` are counted on the
    rays that were timed (walk_work). The walk re-reads the top of the
    tree from cache, so the bytes it must move from HBM are far fewer
    and its share of that bound far smaller: `fraction_of_sol` says how
    far the walk is from a cacheless one, not from the memory system's
    limit. `n_tris` is blink's argument; the traffic depends on the pops
    and tests, not on the scene's size."""
    del n_tris
    nominal_bytes = pops_per_ray * NODE_BYTES + tests_per_ray * TRI_BYTES + RAY_BYTES
    ops = pops_per_ray * NODE_OPS + tests_per_ray * TRI_OPS
    sol = hbm_gbps * 1e9 / nominal_bytes
    sol_fp32 = FP32_TFLOPS * 1e12 / ops
    sol_measured = None if hbm_gbps_measured is None else hbm_gbps_measured * 1e9 / nominal_bytes
    return {
        "bytes_model": "no_reuse",
        "hbm_gbps": hbm_gbps,
        "hbm_gbps_measured": hbm_gbps_measured,
        "fp32_tflops": FP32_TFLOPS,
        "pops_per_ray": pops_per_ray,
        "tests_per_ray": tests_per_ray,
        "nominal_bytes_per_ray": nominal_bytes,
        "ops_per_ray": ops,
        "implied_bytes_per_ray": hbm_gbps * 1e9 / max(rays_per_s, 1.0),
        "sol_rays_per_s_at_nominal": sol,
        "sol_rays_per_s_at_measured_bw": sol_measured,
        "sol_rays_per_s_fp32": sol_fp32,
        "fraction_of_sol": rays_per_s / sol,
        "fraction_of_sol_measured_bw": None if sol_measured is None else rays_per_s / sol_measured,
        "fraction_of_sol_fp32": rays_per_s / sol_fp32,
    }


def run_bench(config_name: str = "sponza", quick: bool = False, device=None,
              backend: str | None = None) -> dict[str, Any]:
    """CLI entry: benchmark one named config (forward, and fwd+bwd for the
    differentiable configs cornell and fit). `backend` overrides the
    config's: Cornell's `auto` picks brute, which runs no kernel. The
    roofline counts the closest-hit walk's work on the config's own
    primary rays (walk_work), so it needs a wide backend; on brute and bvh
    it is skipped."""
    device = resolve_device(device)
    cfg = get_config(config_name).override(backend=backend)
    if quick:
        cfg = cfg.override(
            width=min(cfg.width, 256),
            height=min(cfg.height, 256),
            spp=min(cfg.spp, 4),
            sponza_tris=min(cfg.sponza_tris, 100_000),
        )
    scene = build_scene(cfg).to(device)
    b = make_backend(cfg.backend, scene)
    out: dict[str, Any] = {
        "config": config_name,
        "quick": quick,
        "n_triangles": scene.n_triangles,
        "n_spheres": scene.n_spheres,
        "backend": b.name,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    out["forward"] = bench_render(scene, cfg, b, device)
    if config_name in ("cornell", "fit"):
        out["fwd_bwd"] = bench_render_grad(scene, cfg, ("sphere_center", "albedo"), b, device)
    if b.name == "wide":
        o, d = primary_rays(scene, cfg.height, cfg.width, device)
        pops, tests = walk_work(o, d, b.chunks, device)
        out["roofline"] = roofline(scene.n_triangles, out["forward"]["rays_per_s"],
                                   pops_per_ray=pops, tests_per_ray=tests)
    else:
        out["roofline"] = {"skipped": f"the {b.name} backend has no wide walk to count"}
    return out


def bench_scaling(max_devices: int = 8, size: int = 256, device=None) -> dict[str, Any]:
    """Sharded-render points (dist.render.dist_render, image rows over the
    ranks) of a 20k-triangle Sponza through the bvh backend: one point at
    the world size of the open process group, or in a one-rank group opened
    here. A machine with one card measures world size 1 only, so no
    speedup or parallel efficiency is reported (see `note`)."""
    import torch.distributed as dist

    from blink_torch.dist import mesh
    from blink_torch.dist.render import dist_render

    device = resolve_device(device)
    cfg = get_config("sponza").override(
        width=size, height=size, spp=1, deterministic=True, backend="bvh",
        sponza_tris=20_000,
    )
    scene = build_scene(cfg).to(device)
    backend = make_backend("bvh", scene)
    rays = size * size * cfg.spp
    opened = not dist.is_initialized()
    if opened:
        mesh.init_single_rank("nccl" if device.type == "cuda" else "gloo")
    try:
        n = dist.get_world_size()
        if n > max_devices:
            raise ValueError(f"world size {n} > max_devices {max_devices}")
        dt = _time(lambda: dist_render(scene, cfg, backend=backend, device=device),
                   device=device)
    finally:
        if opened:
            mesh.close()
    return {
        "platform": device.type,
        "world_size": n,
        "note": (f"{n} rank(s) on {device.type}: one point, no speedup measured (it "
                 "needs ranks on separate cards)"),
        "points": [{"devices": n, "rays_per_s": rays / dt, "rays_per_device": rays / n}],
    }
