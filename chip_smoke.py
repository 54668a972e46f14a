#!/usr/bin/env python3
"""Drive blink_torch's main path on one CUDA card and hold its kernels
against their plain torch versions.

    python3 chip_smoke.py

Phases (each asserts; any failure exits non-zero):
  1. build   — compile src/blink_torch/csrc/wide_walk.cu with nvcc and print
               ptxas's register, shared-memory and spill summary;
  2. parity  — on the 1M-triangle Sponza scene with the production BVH,
               the closest-hit and any-hit kernels against their plain
               versions on 65,536 primary rays (every 16th of the 1024x1024
               frame) plus 65,536 random rays, and on shadow rays towards
               the first light;
  3. golden  — the bunny at 128x128, deterministic, through
               blink_torch.api.render, against tests/golden/bunny128_sub5_det.npy;
  4. frame   — Sponza 1M at 1024x1024, 1 spp, stochastic direct lighting
               through render(): launch counts, image checks, the kernels
               again on the frame's own rays, frame and kernel times, and the
               bound implied by the walk's counted node pops and triangle
               tests.
The second-to-last line is {"kernels": [...]}, the last
{"ok": true, "device": {...}}. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from blink_torch.api import build_scene, render  # noqa: E402
from blink_torch.config import get_config  # noqa: E402
from blink_torch.core import sampler  # noqa: E402
from blink_torch.kernels import _build  # noqa: E402
from blink_torch.kernels import api as kapi  # noqa: E402
from blink_torch.kernels import traverse_wide as tw  # noqa: E402
from blink_torch.render import api as render_api  # noqa: E402
from blink_torch.render.camera import generate_rays  # noqa: E402

WIDTH = HEIGHT = 1024
SUBSET = 65_536
#: Peak rates of one H100 SXM (NVIDIA's data sheet): FP32 outside the
#: tensor cores, and HBM3.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
#: FP32 operations per child slab test and per Möller–Trumbore test.
OPS_SLAB = 20
OPS_TRI = 35
TOL = 1e-6

SOURCE = "src/blink_torch/csrc/wide_walk.cu"
REPLACES = "src/blink/kernels/traverse_pallas.py:559"


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


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load("wide_walk")
    log(f"[build] {_build.library_path('wide_walk').name} in {time.perf_counter() - t0:.2f} s")
    for line in _build.log_path("wide_walk").read_text().splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build] {line.strip()}")


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
    """Wraps the traversal entry points kernels.api calls and keeps the
    inputs and outputs of the main path's calls."""

    def __init__(self):
        self.calls = {"wide_closest": [], "wide_anyhit": []}
        self._orig = (kapi.traverse_closest_wide, kapi.traverse_anyhit_wide)

    def __enter__(self):
        fc, fa = self._orig

        def closest(o, d, chunks, t_far=None):
            out = fc(o, d, chunks, t_far=t_far)
            self.calls["wide_closest"].append((o.clone(), d.clone(), t_far, out))
            return out

        def anyhit(o, d, chunks, t_far):
            out = fa(o, d, chunks, t_far)
            self.calls["wide_anyhit"].append((o.clone(), d.clone(), t_far.clone(), out))
            return out

        kapi.traverse_closest_wide, kapi.traverse_anyhit_wide = closest, anyhit
        return self

    def __exit__(self, *exc):
        kapi.traverse_closest_wide, kapi.traverse_anyhit_wide = self._orig


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
    tw.reset_launches()
    with Recorder() as rec:
        img = render(scene, cfg, device=dev, backend=backend)
        torch.cuda.synchronize()
    launches = dict(tw.LAUNCHES)
    log(f"[frame] launches {launches} over {len(chunks)} chunks")
    assert launches == {"wide_closest": len(chunks), "wide_anyhit": len(chunks)}, launches
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
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": kern_ms[name], "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
        })
    return rows, frame_ms


def profile_frame(scene, cfg, dev, backend, frame_ms) -> None:
    """Device time by kernel over one warmed frame (torch.profiler). The
    idle share is measured on that frame, which the profiler slows on the
    host; the share against the unprofiled mean frame is an estimate."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms = events_ms(lambda: render(scene, cfg, device=dev, backend=backend), 1)
    evs = [(e.device_time_total, e) for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    if not evs:
        log("[profile] device time by kernel: not measured (the profiler saw none)")
        return
    total = sum(us for us, _ in evs)
    log(f"[profile] frame {wall_ms:.3f} ms under the profiler, kernels busy "
        f"{total / 1e3:.3f} ms over {len(evs)} kernel names: idle share "
        f"{1 - total / 1e3 / wall_ms:.3f}; estimate against the unprofiled mean "
        f"frame ({frame_ms:.3f} ms): {1 - total / 1e3 / frame_ms:.3f}")
    for us, e in sorted(evs, key=lambda p: -p[0])[:10]:
        log(f"[profile]   {us / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


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
    profile_frame(scene, cfg, dev, backend, frame_ms)

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
