#!/usr/bin/env python3
"""Drive blink_torch's main paths on one CUDA card and hold its kernels
against their plain torch versions.

    python3 chip_smoke.py

Phases (each asserts; any failure exits non-zero):
  1. build    — compile src/blink_torch/csrc/{wide_walk,sphere_pass}.cu with
                nvcc, in parallel, and print ptxas's register,
                shared-memory and spill summaries;
  2. sphere   — the sphere kernel against its plain version on the 65,536
                primary rays of Cornell at 256x256 plus 65,536 random rays,
                with 8 and 64 spheres and a duplicated set (tied minima),
                caps of T_MAX, finite values and 0;
  3. cornell  — the Cornell golden (64x64, deterministic) through the wide
                backend, which runs the sphere kernel, and the wide Hit
                against the brute backend's on the frame's rays;
  4. config 3 — Cornell 256x256 through backend='pallas': render_grad of
                sphere_center and albedo on the card against the same call
                on the CPU, the albedo finite-difference probe, 10 fit
                steps that lower the loss, the time of a fit step, and the
                sphere kernel timed on the path's own inputs;
  5. parity   — on the 1M-triangle Sponza scene with the production BVH,
                the closest-hit and any-hit kernels against their plain
                versions on 65,536 primary rays (every 16th of the
                1024x1024 frame) plus 65,536 random rays, and on shadow rays
                towards the first light;
  6. golden   — the bunny at 128x128, deterministic, through
                blink_torch.api.render, against tests/golden/bunny128_sub5_det.npy;
  7. frame    — Sponza 1M at 1024x1024, 1 spp, stochastic direct lighting
                through render(): launch counts, image checks, the kernels
                again on the frame's own rays, frame and kernel times, the
                bound implied by the walk's counted node pops and triangle
                tests, and one profiled frame;
  8. fwd+bwd  — the metric of record's shape: pixel MSE of the same frame,
                forward only, value-and-grad of albedo+emission, and of
                albedo+emission+tri_verts through render_grad, timed,
                checked (finite, non-zero vertex gradients, the albedo
                finite-difference probe), with peak memory and one profiled
                step.
Each main path is driven with the launch counts set to 0 just before it
and read just after. The second-to-last line is {"kernels": [...]}, the
last {"ok": true, "device": {...}}. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from blink_torch.api import (  # noqa: E402
    build_scene,
    extract_params,
    fit,
    loss_fn,
    render,
    render_grad,
)
from blink_torch.config import FitConfig, get_config  # noqa: E402
from blink_torch.core import sampler  # noqa: E402
from blink_torch.kernels import _build  # noqa: E402
from blink_torch.kernels import api as kapi  # noqa: E402
from blink_torch.kernels import sphere as ks  # noqa: E402
from blink_torch.kernels import traverse_wide as tw  # noqa: E402
from blink_torch.kernels.types import T_MAX, T_MIN  # noqa: E402
from blink_torch.render import api as render_api  # noqa: E402
from blink_torch.render.camera import generate_rays  # noqa: E402

WIDTH = HEIGHT = 1024
SUBSET = 65_536
#: Peak rates of one H100 SXM (NVIDIA's data sheet): FP32 outside the
#: tensor cores, and HBM3.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
#: FP32 operations per child slab test and per Möller–Trumbore test, and
#: per ray-sphere test (the arithmetic of the quadratic and its roots,
#: square root included, compares not counted).
OPS_SLAB = 20
OPS_TRI = 35
OPS_SPHERE = 25
TOL = 1e-6

SOURCE = "src/blink_torch/csrc/wide_walk.cu"
REPLACES = "src/blink/kernels/traverse_pallas.py:559"
SPHERE_SOURCE = "src/blink_torch/csrc/sphere_pass.cu"
SPHERE_REPLACES = "src/blink/kernels/sphere.py:58"
KERNELS = ("wide_walk", "sphere_pass")


def log(*a) -> None:
    print(*a, flush=True)


def events_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` runs, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------- checks


def check_closest(o, d, chunks, t_far, label):
    """Kernel against plain; returns (max |t| error, pops, tests, plain_ms)."""
    t_k, p_k = tw.traverse_closest_wide(o, d, chunks, t_far=t_far)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t_p, p_p, pops, tests = tw.closest_wide_plain(o, d, chunks, t_far=t_far, counts=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = (t_k - t_p).abs().max().item()
    assert torch.allclose(t_k, t_p, rtol=TOL, atol=TOL), (label, err)
    # prim may differ only on an exact tie in t (coincident triangles).
    bad = (p_k != p_p) & (t_k != t_p)
    ties = int(((p_k != p_p) & (t_k == t_p)).sum())
    assert not bad.any(), (label, int(bad.sum()))
    log(f"[parity] closest {label}: {o.shape[0]} rays, hit {float((p_k >= 0).float().mean()):.4f}, "
        f"max|dt| {err:.3g}, prim ties {ties}, plain {plain_ms:.1f} ms")
    return err, pops, tests, plain_ms


def check_anyhit(o, d, chunks, t_far, label):
    b_k = tw.traverse_anyhit_wide(o, d, chunks, t_far)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b_p, pops, tests = tw.anyhit_wide_plain(o, d, chunks, t_far, counts=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    assert torch.equal(b_k, b_p), (label, int((b_k != b_p).sum()))
    log(f"[parity] anyhit {label}: {o.shape[0]} rays, blocked {float(b_k.float().mean()):.4f}, "
        f"identical, plain {plain_ms:.1f} ms")
    return 0.0, pops, tests, plain_ms


def shadow_rays(o, d, t, prim, target):
    """Rays from each closest hit towards `target`; t_far = 0 on misses."""
    hit = prim >= 0
    p = o + torch.where(hit, t, 0.0)[:, None] * d - 1e-3 * d
    to = target[None, :] - p
    dist = torch.linalg.vector_norm(to, dim=1)
    so = p.contiguous()
    sd = (to / dist.clamp(min=1e-12)[:, None]).contiguous()
    return so, sd, torch.where(hit, dist, 0.0).contiguous()


def first_light_point(scene) -> torch.Tensor:
    tri = int(scene.lights.prim[0])
    v = scene.triangles.verts[scene.triangles.idx[tri].long()]
    return v.mean(0)


# ---------------------------------------------------------------- phases


def reset_launches() -> None:
    tw.reset_launches()
    ks.reset_launches()


def launches() -> dict:
    return {**tw.LAUNCHES, **ks.LAUNCHES}


def phase_build() -> None:
    """One nvcc per source, all started together."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        for _ in pool.map(_build.load, KERNELS):
            pass
    log(f"[build] {', '.join(_build.library_path(k).name for k in KERNELS)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for k in KERNELS:
        for line in _build.log_path(k).read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {k}: {line.strip()}")


def phase_parity(scene, backend, dev):
    chunks = backend.chunks
    cam = scene.camera
    pid = render_api.tile_pixel_ids(HEIGHT, WIDTH, *render_api._tile_shape(HEIGHT, WIDTH),
                                    device=dev)[::16]
    o_cam, d_cam, _ = generate_rays(cam, HEIGHT, WIDTH, sampler.seed_key(0, dev), 0,
                                    True, pixel_id=pid)
    rng = np.random.default_rng(2024)
    v = scene.triangles.verts.cpu().numpy()
    o_rnd = rng.uniform(v.min(0), v.max(0), (SUBSET, 3)).astype(np.float32)
    d_rnd = rng.standard_normal((SUBSET, 3)).astype(np.float32)
    d_rnd /= np.linalg.norm(d_rnd, axis=1, keepdims=True)
    o = torch.cat([o_cam, torch.from_numpy(o_rnd).to(dev)]).contiguous()
    d = torch.cat([d_cam, torch.from_numpy(d_rnd).to(dev)]).contiguous()
    err_c, _, _, _ = check_closest(o, d, chunks, None, "primary+random")
    t, prim = tw.traverse_closest_wide(o, d, chunks)
    so, sd, tf = shadow_rays(o, d, t, prim, first_light_point(scene))
    err_a, _, _, _ = check_anyhit(so, sd, chunks, tf, "shadow")
    return {"wide_closest": err_c, "wide_anyhit": err_a}


def phase_golden(dev) -> None:
    cfg = get_config("bunny").override(width=128, height=128, deterministic=True,
                                       bunny_subdiv=5)
    img = render(build_scene(cfg), cfg, device=dev).cpu().numpy()
    gold = np.load(os.path.join(ROOT, "tests", "golden", "bunny128_sub5_det.npy"))
    share = float(np.isclose(img, gold, atol=1e-4).mean())
    log(f"[golden] bunny 128x128 det: {share:.6f} of texels within 1e-4, "
        f"max |diff| {np.abs(img - gold).max():.3g}")
    assert share > 0.999, share


class Recorder:
    """Wraps the kernel entry points kernels.api calls and keeps the inputs
    and outputs of the main path's calls."""

    NAMES = ("traverse_closest_wide", "traverse_anyhit_wide", "sphere_pass")

    def __init__(self):
        self.calls = {"wide_closest": [], "wide_anyhit": [], "sphere_pass": []}
        self._orig = {n: getattr(kapi, n) for n in self.NAMES}

    def __enter__(self):
        fc, fa, fs = (self._orig[n] for n in self.NAMES)

        def closest(o, d, chunks, t_far=None):
            out = fc(o, d, chunks, t_far=t_far)
            self.calls["wide_closest"].append((o.clone(), d.clone(), t_far, out))
            return out

        def anyhit(o, d, chunks, t_far):
            out = fa(o, d, chunks, t_far)
            self.calls["wide_anyhit"].append((o.clone(), d.clone(), t_far.clone(), out))
            return out

        def sphere(o, d, center, radius, t_min, t_max):
            out = fs(o, d, center, radius, t_min, t_max)
            self.calls["sphere_pass"].append(
                (o.clone(), d.clone(), center.clone(), radius.clone(), t_min,
                 t_max.clone(), out))
            return out

        for n, f in zip(self.NAMES, (closest, anyhit, sphere)):
            setattr(kapi, n, f)
        return self

    def __exit__(self, *exc):
        for n, f in self._orig.items():
            setattr(kapi, n, f)


def table_bytes(chunks, n_tris: int) -> int:
    """Bytes of the tables a walk must read: every real node's child, nbox
    and perm records (160 B; the all-zero nodes that pad_chunks_uniform
    appends are unreachable) and v0/e1/e2 of every real triangle (36 B; not
    the records' 3 padding floats, nor the padding records)."""
    nodes = sum(int(c.child.view(-1, 24).ne(0).any(1).sum()) for c in chunks)
    return nodes * (24 + 8 + 8) * 4 + n_tris * 9 * 4


def phase_frame(scene, backend, cfg, dev, errs):
    n = WIDTH * HEIGHT
    chunks = backend.chunks
    reset_launches()
    with Recorder() as rec:
        img = render(scene, cfg, device=dev, backend=backend)
        torch.cuda.synchronize()
    counts = launches()
    log(f"[frame] launches {counts} over {len(chunks)} chunks")
    assert counts == {"wide_closest": len(chunks), "wide_anyhit": len(chunks),
                      "sphere_pass": 0}, counts
    assert len(chunks) == 3, len(chunks)
    img = img.cpu().numpy()
    assert img.shape == (HEIGHT, WIDTH, 3) and np.isfinite(img).all() and (img >= 0).all()
    (o, d, t_far, (t, prim)), = rec.calls["wide_closest"]
    (so, sd, stf, blocked), = rec.calls["wide_anyhit"]
    hit_frac = float((prim >= 0).float().mean())
    log(f"[frame] image mean {img.mean():.5f}, hit fraction {hit_frac:.4f}, "
        f"shadow rays blocked {float(blocked.float().mean()):.4f}")
    assert 0.5 <= hit_frac <= 0.75, hit_frac

    # The kernels again on the frame's own rays, against the plain versions.
    err_c, pops_c, tests_c, plain_c = check_closest(o, d, chunks, t_far, "frame primary")
    err_a, pops_a, tests_a, plain_a = check_anyhit(so, sd, chunks, stf, "frame shadow")
    errs = {"wide_closest": max(errs["wide_closest"], err_c),
            "wide_anyhit": max(errs["wide_anyhit"], err_a)}

    # Times: 5 warmed frames one by one, then each kernel's launches on the
    # frame's rays.
    render(scene, cfg, device=dev, backend=backend)
    frames = [events_ms(lambda: render(scene, cfg, device=dev, backend=backend), 1)
              for _ in range(5)]
    frame_ms = sum(frames) / len(frames)
    log(f"[frame] frame ms {[round(f, 3) for f in frames]}: mean {frame_ms:.3f}, "
        f"min {min(frames):.3f}, max {max(frames):.3f}")
    kern_ms = {
        "wide_closest": events_ms(lambda: tw.traverse_closest_wide(o, d, chunks, t_far=t_far), 5),
        "wide_anyhit": events_ms(lambda: tw.traverse_anyhit_wide(so, sd, chunks, stf), 5),
    }
    log(f"[frame] {WIDTH}x{HEIGHT} direct 1 spp: {frame_ms:.3f} ms, "
        f"{n / frame_ms * 1e3:.4g} rays/s (primary), kernels {kern_ms}")

    # Bound: the walk's counted FP32 work against the bytes it must move:
    # the tables once, o and d (24 B) and t_far (4 B) read per ray; closest
    # hit writes t and prim (8 B) and reads one tri_id per hit, any hit
    # writes one flag byte.
    tb = table_bytes(chunks, scene.n_triangles)
    io_c = n * (24 + (4 if t_far is not None else 0) + 8) + int((prim >= 0).sum()) * 4
    rows = []
    for name, pops, tests, plain_ms, io_bytes in (
        ("wide_closest", pops_c, tests_c, plain_c, io_c),
        ("wide_anyhit", pops_a, tests_a, plain_a, n * (24 + 4 + 1)),
    ):
        p_sum, t_sum = int(pops.sum()), int(tests.sum())
        ops = p_sum * 8 * OPS_SLAB + t_sum * OPS_TRI
        ops_ms = ops / PEAK_FP32 * 1e3
        bytes_ms = (tb + io_bytes) / PEAK_BYTES * 1e3
        bound = max(ops_ms, bytes_ms)
        log(f"[bound] {name}: {p_sum / n:.3f} pops/ray, {t_sum / n:.3f} tri tests/ray, "
            f"{ops:.4g} FP32 ops -> {ops_ms:.4f} ms, {tb + io_bytes} bytes -> "
            f"{bytes_ms:.4f} ms; kernel {kern_ms[name]:.4f} ms = "
            f"{bound / kern_ms[name]:.4f} of the bound")
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES,
            "launches": counts[name], "max_abs_err": errs[name],
            "ms": kern_ms[name], "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
        })
    return rows, frame_ms


def profile(fn, label: str, ref_ms: float) -> None:
    """Device time by kernel over one warmed call of fn (torch.profiler).
    The idle share is measured on that call, which the profiler slows on
    the host; the share against the unprofiled mean `ref_ms` is an
    estimate."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms = events_ms(fn, 1)
    evs = [(e.device_time_total, e) for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    if not evs:
        log(f"[profile] {label}: device time by kernel: not measured (the profiler saw none)")
        return
    total = sum(us for us, _ in evs)
    log(f"[profile] {label} {wall_ms:.3f} ms under the profiler, kernels busy "
        f"{total / 1e3:.3f} ms over {len(evs)} kernel names: idle share "
        f"{1 - total / 1e3 / wall_ms:.3f}; estimate against the unprofiled mean "
        f"({ref_ms:.3f} ms): {1 - total / 1e3 / ref_ms:.3f}")
    for us, e in sorted(evs, key=lambda p: -p[0])[:12]:
        log(f"[profile]   {us / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def primary_rays(scene, size: int, dev, jitter: bool = True):
    """The size x size frame's primary rays of sample 0, in tile order."""
    tile = render_api._tile_shape(size, size)
    pid = render_api.tile_pixel_ids(size, size, *tile, device=dev) if tile else None
    o, d, _ = generate_rays(scene.camera, size, size, sampler.seed_key(0, dev), 0,
                            jitter, pixel_id=pid)
    return o.contiguous(), d.contiguous()


def check_sphere(o, d, center, radius, caps, label):
    """The sphere kernel against its plain version; returns (max |t|
    error, prim)."""
    t_k, p_k = ks.sphere_pass(o, d, center, radius, T_MIN, caps)
    t_p, p_p = ks.sphere_pass_plain(o, d, center, radius, T_MIN, caps)
    torch.cuda.synchronize()
    err = (t_k - t_p).abs().max().item()
    log(f"[sphere] {label}: {o.shape[0]} rays, {center.shape[0]} spheres, hit "
        f"{float((t_k < T_MAX).float().mean()):.4f}, max|dt| {err:.3g}, "
        f"prim mismatches {int((p_k != p_p).sum())}")
    assert torch.equal(p_k, p_p), label
    assert torch.allclose(t_k, t_p, rtol=TOL, atol=TOL), (label, err)
    return err, p_k


def phase_sphere_parity(dev, size: int = 256, n_random: int = SUBSET) -> float:
    """The kernel against its plain version on Cornell's primary rays and
    random rays, with 8, 64 and twice 8 spheres, caps of T_MAX, finite
    values and 0 in turn."""
    scene = build_scene(get_config("fit")).to(dev)
    o_cam, d_cam = primary_rays(scene, size, dev)
    rng = np.random.default_rng(2025)
    o_rnd = rng.uniform([-1.5, 0.0, -1.5], [1.5, 1.2, 1.5], (n_random, 3))
    d_rnd = rng.standard_normal((n_random, 3))
    d_rnd /= np.linalg.norm(d_rnd, axis=1, keepdims=True)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    o = torch.cat([o_cam, f32(o_rnd)]).contiguous()
    d = torch.cat([d_cam, f32(d_rnd)]).contiguous()
    m = o.shape[0]
    kind = np.arange(m) % 3
    caps = f32(np.where(kind == 0, T_MAX, np.where(kind == 1, rng.uniform(0.1, 5.0, m), 0.0)))
    c8, r8 = scene.spheres.center, scene.spheres.radius
    c64 = f32(rng.uniform([-1.5, 0.1, -1.5], [1.5, 1.5, 1.5], (64, 3)))
    r64 = f32(rng.uniform(0.05, 0.3, 64))
    err = 0.0
    for label, c, r in (("8 spheres", c8, r8), ("64 spheres", c64, r64),
                        ("8 spheres twice", torch.cat([c8, c8]), torch.cat([r8, r8]))):
        e, prim = check_sphere(o, d, c, r, caps, label)
        err = max(err, e)
    assert (prim < 8).all()  # of tied minima, the first wins
    return err


def phase_cornell(dev) -> None:
    """The Cornell golden through the wide backend, whose sphere pass is the
    kernel, and the wide Hit against brute's on the frame's rays."""
    cfg = get_config("cornell").override(width=64, height=64, deterministic=True,
                                         backend="wide")
    scene = build_scene(cfg).to(dev)
    backend = kapi.make_backend("wide", scene)
    reset_launches()
    img = render(scene, cfg, device=dev, backend=backend)
    torch.cuda.synchronize()
    counts = launches()
    img = img.cpu().numpy()
    gold = np.load(os.path.join(ROOT, "tests", "golden", "cornell_64_det.npy"))
    share = float(np.isclose(img, gold, atol=1e-4).mean())
    log(f"[cornell] golden 64x64 det through wide: {share:.6f} of texels within 1e-4, "
        f"max |diff| {np.abs(img - gold).max():.3g}, launches {counts}")
    assert share > 0.999, share
    # One closest-hit pass, then one occlusion pass per light.
    assert counts == {"wide_closest": 1, "wide_anyhit": scene.n_lights,
                      "sphere_pass": 1 + scene.n_lights}, counts
    o, d = primary_rays(scene, 64, dev, jitter=False)
    hw = backend.intersect(o, d, scene)
    hb = kapi.make_backend("brute", scene).intersect(o, d, scene)
    err = (hw.t - hb.t).abs().max().item()
    log(f"[cornell] Hit wide vs brute on {o.shape[0]} rays: kind identical "
        f"{torch.equal(hw.kind, hb.kind)}, prim identical {torch.equal(hw.prim, hb.prim)}, "
        f"max|dt| {err:.3g}")
    assert torch.equal(hw.kind, hb.kind) and torch.equal(hw.prim, hb.prim)
    assert torch.allclose(hw.t, hb.t, rtol=TOL, atol=TOL), err


def albedo_fd_probe(scene, cfg, backend, target, g_albedo, label) -> float:
    """bench.py's probe: the 3 largest albedo gradients against f32 central
    differences (albedo enters the image linearly), rel < 0.05."""
    x0 = scene.materials.albedo

    def loss(a):
        with torch.no_grad():
            return float(loss_fn({"albedo": a}, scene, cfg, backend, target))

    g = g_albedo.cpu().numpy().ravel()
    worst = 0.0
    for fi in np.argsort(-np.abs(g))[:3]:
        e = torch.zeros(x0.numel(), device=x0.device)
        e[fi] = 1e-2
        e = e.view_as(x0)
        fd = (loss(x0 + e) - loss(x0 - e)) / 2e-2
        worst = max(worst, abs(g[fi] - fd) / max(abs(fd), 1e-6))
    log(f"[{label}] albedo FD probe: worst rel err {worst:.3g} over the 3 largest components")
    assert worst < 0.05, worst
    return worst


#: Config 3's gradients on the card against the same call on the CPU,
#: within rtol GRAD_RTOL and an atol of GRAD_ATOL_SHARE of the largest |g|.
#: The f32 sums over 65,536 pixels run in other orders (atomic adds in the
#: backward of the index gathers, another reduction tree for the mean), and
#: the card's tan may differ from the CPU's by an ulp, which can flip the
#: hit of a pixel that grazes a silhouette; one such pixel moves a
#: gradient by at most about 2/65,536 of a pixel's radiance.
GRAD_RTOL, GRAD_ATOL_SHARE = 1e-3, 1e-3


def phase_config3(dev, steps: int = 10, size: int | None = None):
    """Config 3 (Cornell 256x256, backend 'pallas'): render_grad and fit on
    the card through the wide walks and the sphere kernel. Returns the
    sphere kernel's row of the kernels line."""
    cfg = get_config("fit").override(backend="pallas", width=size, height=size)
    scene = build_scene(cfg).to(dev)
    backend = kapi.make_backend(cfg.backend, scene)
    target = render(scene, cfg, device=dev, backend=backend)
    gen = torch.Generator().manual_seed(cfg.seed + 1)
    noise = 0.15 * torch.randn(scene.spheres.center.shape, generator=gen)
    scene0 = scene.replace(spheres=scene.spheres.replace(
        center=scene.spheres.center + noise.to(dev)))
    names = ("sphere_center", "albedo")
    fit_cfg = FitConfig(steps=steps, log_path=os.devnull)

    reset_launches()
    with Recorder() as rec:
        loss, g = render_grad(scene0, cfg, target, names, device=dev, backend=backend)
        _, hist = fit(scene0, target, cfg, fit_cfg, device=dev, backend=backend)
        torch.cuda.synchronize()
    counts = launches()
    renders = 1 + steps
    log(f"[config3] {cfg.width}x{cfg.height}, launches {counts} over {renders} renders")
    assert counts == {"wide_closest": renders, "wide_anyhit": renders,
                      "sphere_pass": 2 * renders}, counts
    log(f"[config3] fit losses {[round(h, 6) for h in hist]}")
    assert np.isfinite(hist).all() and hist[-1] < hist[0], hist

    loss_c, g_c = render_grad(scene0.to("cpu"), cfg, target.cpu(), names, device="cpu")
    log(f"[config3] loss card {loss.item():.8g}, CPU {loss_c.item():.8g}")
    assert abs(loss.item() - loss_c.item()) <= 1e-4 * abs(loss_c.item()), (loss, loss_c)
    for n in names:
        a, b = g[n].cpu(), g_c[n]
        scale = b.abs().max().item()
        log(f"[config3] grad {n}: card vs CPU max|diff| {(a - b).abs().max().item():.3g}, "
            f"max|g| {scale:.3g}")
        assert torch.isfinite(a).all() and scale > 0, n
        assert torch.allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL_SHARE * scale), n
    albedo_fd_probe(scene0, cfg, backend, target, g["albedo"], "config3")

    fit(scene0, target, cfg, fit_cfg, device=dev, backend=backend)
    step_ms = [events_ms(lambda: fit(scene0, target, cfg, fit_cfg, device=dev,
                                     backend=backend), 1) / steps for _ in range(3)]
    log(f"[config3] fit step ms (3 runs of {steps} steps): {[round(t, 3) for t in step_ms]}, "
        f"mean {sum(step_ms) / 3:.3f}")

    # The kernel on the path's own inputs: every recorded call against the
    # plain version, then the first (closest hit) timed.
    err = 0.0
    for o, d, c, r, t_min, t_max, (t_k, p_k) in rec.calls["sphere_pass"]:
        t_p, p_p = ks.sphere_pass_plain(o, d, c, r, t_min, t_max)
        assert torch.equal(p_k, p_p)
        assert torch.allclose(t_k, t_p, rtol=TOL, atol=TOL)
        err = max(err, (t_k - t_p).abs().max().item())
    o, d, c, r, t_min, t_max, _ = rec.calls["sphere_pass"][0]
    call_ms = events_ms(lambda: ks.sphere_pass(o, d, c, r, t_min, t_max), 100)
    ms = kernel_device_ms(lambda: ks.sphere_pass(o, d, c, r, t_min, t_max), 100,
                          "sphere_pass_kernel")
    log(f"[config3] sphere_pass: {call_ms:.5f} ms a wrapper call (CUDA events over 100 "
        f"calls, the host's launch overhead included), kernel {ms} ms a launch on the "
        f"device (torch.profiler)")
    if ms is None:
        ms = call_ms
    plain_ms = events_ms(lambda: ks.sphere_pass_plain(o, d, c, r, t_min, t_max), 5)
    n, s = o.shape[0], c.shape[0]
    nbytes = n * (12 + 12 + 4 + 4 + 4) + s * 16
    ops = n * s * OPS_SPHERE
    ops_ms, bytes_ms = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    log(f"[bound] sphere_pass: {n} rays x {s} spheres, {ops} FP32 ops -> {ops_ms:.5f} ms, "
        f"{nbytes} bytes -> {bytes_ms:.5f} ms; kernel {ms:.5f} ms, plain {plain_ms:.4f} ms, "
        f"{max(ops_ms, bytes_ms) / ms:.4f} of the bound; {len(rec.calls['sphere_pass'])} "
        f"recorded calls identical in prim, max|dt| {err:.3g}")
    return {
        "name": "sphere_pass", "route": "cuda", "source": SPHERE_SOURCE,
        "replaces": SPHERE_REPLACES, "launches": counts["sphere_pass"],
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }


def kernel_device_ms(fn, reps: int, name: str):
    """Device milliseconds per launch of the kernels whose name holds
    `name`, over `reps` calls of fn (torch.profiler); None if the profiler
    saw none."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key]
    count = sum(e.count for e in evs)
    return sum(e.device_time_total for e in evs) / 1e3 / count if count else None


def timed_in_turns(fns, reps: int = 5) -> list:
    """Milliseconds of `reps` warmed calls of each fn, each call timed on
    its own, the fns taken in turns so that a drift of the host's speed
    reaches all of them alike."""
    for fn in fns:
        fn()
    out = [[] for _ in fns]
    for _ in range(reps):
        for fn, t in zip(fns, out):
            t.append(events_ms(fn, 1))
    return out


def phase_fwd_bwd(scene, backend, dev, size: int = WIDTH) -> None:
    """bench.py::_fwd_bwd on the card: pixel MSE of the 1 spp direct frame
    against a zero target, forward only, and value-and-grad of the
    materials and of materials plus vertices through render_grad."""
    cfg = get_config("sponza").override(width=size, height=size, spp=1,
                                        integrator="direct", backend="pallas")
    target = torch.zeros((size, size, 3), device=dev)
    mat = ("albedo", "emission")
    geo = mat + ("tri_verts",)
    n_chunks = len(backend.chunks)

    def fwd():
        with torch.no_grad():
            return loss_fn(extract_params(scene, mat), scene, cfg, backend, target)

    def vg(names):
        return render_grad(scene, cfg, target, names, device=dev, backend=backend)

    reset_launches()
    loss, g = vg(geo)
    torch.cuda.synchronize()
    counts = launches()
    log(f"[fwd+bwd] {size}x{size} albedo+emission+tri_verts: loss {loss.item():.6g}, "
        f"launches {counts}")
    assert counts == {"wide_closest": n_chunks, "wide_anyhit": n_chunks,
                      "sphere_pass": 0}, counts
    for n, v in g.items():
        assert torch.isfinite(v).all(), n
    moved = int((g["tri_verts"].abs().sum(1) > 0).sum())
    log(f"[fwd+bwd] grads finite; |g| max: "
        + ", ".join(f"{n} {v.abs().max().item():.3g}" for n, v in g.items())
        + f"; {moved} of {g['tri_verts'].shape[0]} vertices have a non-zero gradient")
    assert moved > 0
    albedo_fd_probe(scene, cfg, backend, target, g["albedo"], "fwd+bwd")

    t_f, t_m, t_g = timed_in_turns([fwd, lambda: vg(mat), lambda: vg(geo)])
    for label, t in (("fwd only", t_f), ("fwd+bwd materials", t_m),
                     ("fwd+bwd geometry", t_g)):
        log(f"[fwd+bwd] {label} ms {[round(x, 3) for x in t]}: mean {sum(t) / len(t):.3f}, "
            f"min {min(t):.3f}, max {max(t):.3f}")
    mf, mm, mg = (sum(t) / len(t) for t in (t_f, t_m, t_g))
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    vg(geo)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    rays = size * size
    log("[fwd+bwd] " + json.dumps({
        "rays_per_s_fwd_bwd": rays / (mg / 1e3), "wall_s": mg / 1e3,
        "image": [size, size], "fwd_only_wall_s": mf / 1e3,
        "bwd_over_fwd_geometry": mg / mf,
        "materials_only": {"wall_s": mm / 1e3, "rays_per_s_fwd_bwd": rays / (mm / 1e3),
                           "bwd_over_fwd": mm / mf},
        "max_memory_allocated": peak, "memory_allocated_before": before,
    }))
    profile(lambda: vg(geo), "fwd+bwd geometry", mg)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    phase_build()
    sphere_err = phase_sphere_parity(dev)
    phase_cornell(dev)
    sphere_row = phase_config3(dev)
    sphere_row["max_abs_err"] = max(sphere_row["max_abs_err"], sphere_err)

    cfg = get_config("sponza").override(width=WIDTH, height=HEIGHT, spp=1,
                                        integrator="direct")
    t0 = time.perf_counter()
    scene = build_scene(cfg).to(dev)
    t1 = time.perf_counter()
    backend = kapi.make_backend(cfg.backend, scene)
    t2 = time.perf_counter()
    log(f"[scene] sponza {scene.n_triangles} triangles, {scene.n_lights} lights, "
        f"{scene.n_spheres} spheres: scene {t1 - t0:.1f} s, BVH {t2 - t1:.1f} s, "
        f"{len(backend.chunks)} chunks, max_stack {backend.chunks[0].max_stack}, "
        f"{table_bytes(backend.chunks, scene.n_triangles)} table bytes a walk must read")

    errs = phase_parity(scene, backend, dev)
    phase_golden(dev)
    rows, frame_ms = phase_frame(scene, backend, cfg, dev, errs)
    profile(lambda: render(scene, cfg, device=dev, backend=backend), "frame", frame_ms)
    phase_fwd_bwd(scene, backend, dev)
    rows.append(sphere_row)

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
