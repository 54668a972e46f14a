#!/usr/bin/env python3
"""Drive blink_torch's main paths on one CUDA card and hold its kernels
against their plain torch versions.

    python3 chip_smoke.py

Phases (each asserts; any failure exits non-zero):
  1. build    — compile src/blink_torch/csrc/{wide_walk,sphere_pass,
                binary_walk}.cu, the counting builds of wide_walk.cu
                (-DWIDE_WALK_COUNTS) and binary_walk.cu
                (-DBINARY_WALK_COUNTS) and the empty build of
                sphere_pass.cu (-DSPHERE_PASS_EMPTY) with nvcc, in
                parallel, and print ptxas's register, shared-memory and
                spill summaries;
  2. sphere   — the sphere kernel's two entries (sphere_pass, and
                sphere_merge, which merges the pass into a closest hit)
                against their plain versions bit for bit on the 65,536
                primary rays of Cornell at 256x256 plus 65,536 random rays,
                with 8 and 64 spheres and a duplicated set (tied minima),
                caps of T_MAX, finite values and 0;
  3. cornell  — the Cornell golden (64x64, deterministic) through the wide
                backend, which runs the sphere kernel, and the wide Hit
                against the brute backend's on the frame's rays;
  4. config 3 — Cornell 256x256 through backend='pallas': render_grad of
                sphere_center and albedo on the card against the same call
                on the CPU, the albedo finite-difference probe, 10 fit
                steps that lower the loss, the time of a fit step; every
                recorded sphere call held bit for bit, and on the path's
                own inputs the sphere kernel's device time, its empty
                build's (the floor; also at 1,048,576 rays), the wrapper
                calls' times, the launches the caller made around the
                kernel before (the merge, the table's torch.cat), and the
                kernel's registers and resident warps an SM;
  4b. soft    — config 3 with soft_sigma 0.15, deterministic: one soft
                render's launches as li_direct_soft implies them
                (soft_launches: 2 closest hits, 6 shadow tests, 1
                sphere_merge, 4 sphere_pass), every recorded walk and
                sphere call bit for bit to its plain version, the image
                equal to the hard one and to the numpy oracle
                (blink_torch.ref, rendered in a process of its own since
                the start) by the goldens' rule; the soft sphere_center
                gradient on the card against the CPU's; soft and hard
                fwd+bwd times; the position fit of tests/test_fit.py (120
                Adam steps) at 48x48 to blink's bounds and at 256x256
                (both ratios must fall);
  4c. softmesh — config 2's bunny at 512x512, 1 spp, deterministic,
                soft_sigma 1.0 and soft_mesh: the launches (2 closest
                hits, 12 shadow tests), both closest hits' rays in
                row-major pixel order, the image equal to the hard one,
                every walk bit for bit; a finite, non-zero tri_verts
                gradient; soft and hard fwd+bwd times; the mesh-offset
                recovery of tests/test_fit.py (bunny_scene(2), 48x48, 50
                steps, the backend built anew each step) to blink's bounds;
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
                tests (bound from the seen marks), the walks' registers,
                spills and resident warps an SM, with their times before
                their redesign (PR 5's, for the log only), and one
                profiled frame;
  8. fwd+bwd  — the metric of record's shape: pixel MSE of the same frame,
                forward only, value-and-grad of albedo+emission, and of
                albedo+emission+tri_verts through render_grad, timed,
                checked (finite, non-zero vertex gradients, the albedo
                finite-difference probe), with peak memory and one profiled
                step.
  8b. bench   — the port's bench harness on the same scene and backend
                (blink_torch.benchmarks): the headline's stages in turn —
                the primary traversal at 1024x1024 (exactly one closest-hit
                wide_group_walk launch a chunk a call), grad_allclose,
                fwd+bwd, scaling at world size 1 (skip_walk only), config 4
                and config 5's unit — with every plain walk and plain sphere
                pass made to raise, each stage's launches asserted, the
                headline's JSON line printed and its keys, finite positive
                numbers and grad_allclose's pass checked; run_bench of
                cornell and fit (quick, through pallas: sphere_merge and
                sphere_pass launch); then the tooling on the card: a
                checkpoint of CUDA tensors loaded back equal, fit for 4
                steps against 2 + a resume for 2 on Cornell 64x64 (within
                the stated tolerance; the largest difference printed),
                refit_bvh on the card equal to the CPU's, and a trace() of
                one fwd+bwd step (whether it names the walk kernels).
  9. config 4 — the sponza preset uncut (512x512, 16 spp, path depth 4,
                spp_block 16, compact, rr_start 1) on the same scene and
                backend: 4 x 3 closest and 4 x 3 any-hit launches, each
                bounce's two calls against the plain walks bit for bit on
                every 32nd ray and on all its live rays (t_far > 0), with
                the live share, pops and tests a live ray, the walk's time
                on the call's full inputs and its bound (live rays' work);
                the image without compaction identical; 3 timed frames,
                camera samples/s, peak memory and one profiled frame. Rows
                1-2 of the kernels line gain the frame's launches and the
                walks' summed time and bound (config4_*). After the
                launch asserts, each bounce's skip walk on the same inputs
                is timed beside group's (skip/group on one design), with
                both counting builds' pops;
 10. config 5 — the pod preset's per-card unit (4096x512, 1 spp, depth 4,
                compact, rr_start 1): launches, the first bounce's walks
                against the plain ones on every 32nd ray, 3 timed frames;
 11. leafmode — every variant of the wide walk on the same scene, over
                three layouts: (a) 150k-triangle chunks, wide leaves of 44,
                quantized boxes, row tables; (b) build_chunked_wide's
                defaults, 120k-triangle chunks, leaves of 32, f32 boxes,
                row tables; (c) layout (a) with f32 boxes (group and skip
                only). On the 1024x1024 frame's primary rays and their
                shadow rays: each variant once through its wrapper (the
                counts), row and stream against group bit for bit, skip
                missing everything, group against the production walk;
                each output against its plain version bit for bit, with
                the counts and seen marks for its bound; the counting
                build's pops and tests of every schedule against the plain
                walk's, ray for ray; its time, registers, spills and
                resident warps an SM. Then the frame through render()
                on a layout-(a) backend under BLINK_LEAF_MODE=group, row
                and stream: each frame's walks against their plain
                versions bit for bit on their own rays, identical images,
                each variant's launches; the row/group, stream/group and
                skip/group time ratios of each layout (every schedule runs
                one design) with 1 - skip/group, the leaf tests' share of a
                group walk; and the production backend under
                BLINK_LEAF_MODE=row (group launches).
 12. binary   — Sponza 1M in 9 packed SAH chunks of up to 120,000
                triangles (leaf 16): the packed traversal drives the four
                binary-walk entry points once; each against its plain
                version on 65,536 primary rays (every 16th of the 1024x1024
                frame) plus 65,536 random rays, and on their shadow rays
                towards the first light with a third of t_far 0; the
                chunked closest hit against the wide backend, with the
                count of exact t ties; node visits and triangle tests per
                ray from the plain versions, for the bound; the ordered
                walks' counting build against the plain walk's pops and
                tests ray for ray, with its warp turns and SIMT
                efficiency; their registers, spills and resident warps an
                SM;
 13. config 2 — the bunny (81,924 triangles) at 512x512, 4 spp, stochastic
                direct, through backend 'bvh' and render(): 4 skip-link
                closest and 4 any-hit launches, the kernels against their
                plain versions on the frame's own rays, and the counting
                build's node visits and triangle tests against the plain
                walk's ray for ray there, with its warp turns and SIMT
                efficiency; the image against the wide backend's, the bunny
                golden through bvh, frame and walk times, and the skip-link
                walks' registers, spills and resident warps an SM;
 13b. bvhvariants — the instanced hall (sponza_scene_instanced, 200,000
                triangles): SBVH chunks (build_chunked_wide(spatial=True),
                the production constants; build seconds) through both wide
                kernels on 512x512 primary rays and their shadow rays, bit
                for bit to the plain walks, and against the object-split
                chunks (t identical, prim ties counted, the same blocked
                flags), with both layouts' times; the TLAS probe
                (blink_torch.benchmarks.tlas_probe.run) on the card at
                65,536 rays, the two-level walk's hits against the flat
                walk's (hits equal, t within 1e-5), its JSON line printed;
 14. shard    — a one-rank NCCL group: scene-sharded traversal of the
                1024x1024 frame's primary rays and their shadow rays over
                build_sharded_chunks(tris, 1) (9 padded chunks), its two
                kernels bit for bit equal to their plain versions there,
                the result equal to the replicated packed traversal and to
                the wide backend (up to exact t ties), with the walks'
                times; then both ordered kernels at that size (the any hit
                on the shadow rays, off the path), bit for bit, the
                counting build ray for ray, each one's time, bound and SIMT
                efficiency (the ordered rows' shard_* keys);
 15. dist     — on config 2 through bvh, dist_render equals render bit for
                bit and dist_render_grad matches render_grad; with the path
                integrator at depth 4, dist_render equals render bit for
                bit, and each of the frame's 16 + 16 skip-link calls is held
                bit for bit to the plain walk on all its rays, with the
                counting build on sample 0's calls, each call's time and
                its bound over live lanes. The skip-link rows of the
                kernels line gain path_launches, path_ms and path_bound_ms.
Each main path is driven with the launch counts set to 0 just before it
and read just after; each phase's seconds are logged. The second-to-last line is {"kernels": [...]}, the
last {"ok": true, "device": {...}}. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

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
from blink_torch.kernels import traverse_packed as tp  # noqa: E402
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
BINARY_SOURCE = "src/blink_torch/csrc/binary_walk.cu"
#: The TPU kernel each binary entry point replaces (builders in
#: traverse_pallas.py, all reaching pallas_call at :1296).
BINARY_REPLACES = {
    "skip_closest": "src/blink/kernels/traverse_pallas.py:238",
    "skip_anyhit": "src/blink/kernels/traverse_pallas.py:238",
    "ordered_closest": "src/blink/kernels/traverse_pallas.py:348",
    "ordered_anyhit": "src/blink/kernels/traverse_pallas.py:449",
}
KERNELS = ("wide_walk", "sphere_pass", "binary_walk")
#: The production walks' times before their redesign for latency (ms at
#: 1,048,576 rays: the production layout's 3 chunks, layout (a)'s 7), from
#: this script's run on an H100 80GB HBM3 at 700 W (PERF.md §6, rows 1-2,
#: PR 5). Printed in the log beside this run's times; not in the kernels line.
PR5_MS = {"wide_closest": (1.6699, 2.8132), "wide_anyhit": (1.1791, 1.8534)}
#: The skip schedule's times on its first design (ms at 1,048,576 rays, by
#: layout, closest and any hit), from this script's run on an H100 80GB
#: HBM3 at 700 W (PERF.md §6, row 3c). For the log only.
FIRST_SKIP_MS = {"a": (0.7606, 0.6942), "b": (0.7626, 0.6694), "c": (0.6124, 0.5402)}


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


def check_closest(o, d, chunks, t_far, label, seen=None):
    """Kernel against plain; returns (max |t| error, pops, tests, plain_ms,
    (t, prim))."""
    t_k, p_k = tw.traverse_closest_wide(o, d, chunks, t_far=t_far)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t_p, p_p, pops, tests = tw.closest_wide_plain(o, d, chunks, t_far=t_far, counts=True,
                                                  seen=seen)
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
    return err, pops, tests, plain_ms, (t_k, p_k)


def check_anyhit(o, d, chunks, t_far, label, seen=None):
    b_k = tw.traverse_anyhit_wide(o, d, chunks, t_far)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b_p, pops, tests = tw.anyhit_wide_plain(o, d, chunks, t_far, counts=True, seen=seen)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    assert torch.equal(b_k, b_p), (label, int((b_k != b_p).sum()))
    log(f"[parity] anyhit {label}: {o.shape[0]} rays, blocked {float(b_k.float().mean()):.4f}, "
        f"identical, plain {plain_ms:.1f} ms")
    return max_abs_err(b_k, b_p), pops, tests, plain_ms, b_k


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
    tp.reset_launches()


def launches() -> dict:
    return {**tw.LAUNCHES, **ks.LAUNCHES, **tp.LAUNCHES}


def only(**counts) -> dict:
    """Every kernel's launch count: `counts`, and 0 for the others."""
    return {**{k: 0 for k in launches()}, **counts}


def phase_build() -> None:
    """One nvcc per source, and one for each counting build, all started
    together."""
    t0 = time.perf_counter()
    builds = [(k, ()) for k in KERNELS] + [("wide_walk", tw.COUNTS_DEFINES),
                                           ("binary_walk", tp.COUNTS_DEFINES),
                                           ("sphere_pass", ks.EMPTY_DEFINES)]
    with ThreadPoolExecutor(len(builds)) as pool:
        for _ in pool.map(lambda b: _build.load(*b), builds):
            pass
    log(f"[build] {', '.join(_build.library_path(*b).name for b in builds)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for k in KERNELS:
        for line in _build.log_path(k).read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {k}: {line.strip()}")


def wide_kernel_facts(any_hit: bool, mode: str = "group", quant: bool = True) -> dict:
    """Registers, local memory and resident warps an SM (the runtime) and
    spilled bytes (ptxas) of a wide walk's kernel; by default a production
    walk, wide_group_walk<any_hit, quantized boxes, group>."""
    spills = _build.ptxas_spills(_build.log_path("wide_walk").read_text())
    [spill] = [v for k, v in spills.items() if tw.kernel_symbol(any_hit, mode, quant) in k]
    a = tw.kernel_attributes(any_hit, mode, quant)
    return {"registers": a["registers"], "spill_bytes": spill, "local_bytes": a["local_bytes"],
            "warps_per_sm": a["warps_per_sm"]}


def binary_kernel_facts(kind: str) -> dict:
    """Registers, local memory and resident warps an SM (the runtime) and
    spilled bytes (ptxas) of a binary walk's kernel: skip_walk<any_hit> or
    ordered_walk<any_hit>."""
    spills = _build.ptxas_spills(_build.log_path("binary_walk").read_text())
    walk = "9skip_walk" if kind.startswith("skip") else "12ordered_walk"
    [spill] = [v for k, v in spills.items()
               if f"{walk}ILb{int(kind.endswith('anyhit'))}E" in k]
    a = tp.kernel_attributes(kind)
    return {"registers": a["registers"], "spill_bytes": spill, "local_bytes": a["local_bytes"],
            "warps_per_sm": a["warps_per_sm"]}


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
    err_c, _, _, _, (t, prim) = check_closest(o, d, chunks, None, "primary+random")
    so, sd, tf = shadow_rays(o, d, t, prim, first_light_point(scene))
    err_a, _, _, _, _ = check_anyhit(so, sd, chunks, tf, "shadow")
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

    NAMES = ("traverse_closest_wide", "traverse_anyhit_wide", "sphere_pass",
             "sphere_merge", "traverse_closest_packed", "traverse_anyhit_packed")

    def __init__(self):
        self.calls = {"wide_closest": [], "wide_anyhit": [], "sphere_pass": [],
                      "sphere_merge": [], "packed_closest": [], "packed_anyhit": []}
        self._orig = {n: getattr(kapi, n) for n in self.NAMES}

    def __enter__(self):
        fc, fa, fs, fm, pc, pa = (self._orig[n] for n in self.NAMES)

        def closest(o, d, chunks, t_far=None, leaf_mode=None):
            out = fc(o, d, chunks, t_far=t_far, leaf_mode=leaf_mode)
            self.calls["wide_closest"].append((o.clone(), d.clone(), t_far, out))
            return out

        def anyhit(o, d, chunks, t_far, leaf_mode=None):
            out = fa(o, d, chunks, t_far, leaf_mode=leaf_mode)
            self.calls["wide_anyhit"].append((o.clone(), d.clone(), t_far.clone(), out))
            return out

        def sphere(o, d, center, radius, t_min, t_max):
            out = fs(o, d, center, radius, t_min, t_max)
            self.calls["sphere_pass"].append(
                (o.clone(), d.clone(), center.clone(), radius.clone(), t_min,
                 t_max.clone(), out))
            return out

        def merge(o, d, center, radius, t_min, t, kind, prim):
            out = fm(o, d, center, radius, t_min, t, kind, prim)
            self.calls["sphere_merge"].append(
                (o.clone(), d.clone(), center.clone(), radius.clone(), t_min,
                 (t.clone(), kind.clone(), prim.clone()), out))
            return out

        def packed_closest(o, d, bvh, t_far=None, variant=tp.CLOSEST_VARIANT):
            out = pc(o, d, bvh, t_far=t_far, variant=variant)
            self.calls["packed_closest"].append((o.clone(), d.clone(), variant, out))
            return out

        def packed_anyhit(o, d, bvh, t_far, variant="skip"):
            out = pa(o, d, bvh, t_far, variant=variant)
            self.calls["packed_anyhit"].append(
                (o.clone(), d.clone(), t_far.clone(), variant, out))
            return out

        for n, f in zip(self.NAMES, (closest, anyhit, sphere, merge, packed_closest,
                                     packed_anyhit)):
            setattr(kapi, n, f)
        return self

    def __exit__(self, *exc):
        for n, f in self._orig.items():
            setattr(kapi, n, f)


def wide_table_bytes(chunks, seen, mode: str) -> tuple:
    """(bytes, nodes, leaf rows) of the tables a wide walk cannot avoid
    reading, from the plain version's `seen` marks: of each node some ray
    popped, its child records (8 x 12 B quantized, 8 x 32 B f32), its
    dequantization frame (32 B, quantized only), its octant orders (32 B)
    and, in the row and stream modes, its batch refs (32 B); of each
    triangle slot some ray tested, v0/e1/e2 (36 B); of each batch some ray
    read, v0/e1/e2 and gid (40 B) of each real triangle in it; each once."""
    quant, batched = chunks[0].quant, mode in ("row", "stream")
    node_b = (96 + 32 if quant else 256) + 32 + (32 if batched else 0)
    nodes = sum(int(m.sum()) for m, _ in seen)
    leaf_rows = sum(int(m.sum()) for _, m in seen)
    if batched:
        leaf_b = sum(int((c.tbat[m, :, 9] >= 0).sum()) * 40 for c, (_, m) in zip(chunks, seen))
    else:
        leaf_b = leaf_rows * 36
    return nodes * node_b + leaf_b, nodes, leaf_rows


def wide_bound(name, chunks, mode, seen, pops, tests, n, t_far: bool, hits: int,
               n_read: int | None = None):
    """(bound ms, bound_by) of a wide walk over n rays from its counted
    node pops (8 slab tests each) and triangle tests, against the bytes it
    must move: the table rows it read once (wide_table_bytes), o and d
    (24 B) of each of the n_read rays that are walked (all n unless given:
    a dead lane of a path bounce, t_far = 0, needs only its t_far), t_far
    (4 B) per ray, and t and prim (8 B) per ray and, in the group mode, one
    tri_id per hit for closest hit, one flag byte for any hit. `pops`,
    `tests` and `seen` are those of the walked rays."""
    n_read = n if n_read is None else n_read
    ops = int(pops.sum()) * 8 * OPS_SLAB + int(tests.sum()) * OPS_TRI
    io = n_read * 24 + n * (4 if t_far else 0)
    if name.startswith("wide_closest"):
        io += n * 8 + (hits * 4 if mode == "group" else 0)
    else:
        io += n
    tables, nodes, leaf_rows = wide_table_bytes(chunks, seen, mode)
    nbytes = tables + io
    ops_ms, bytes_ms = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    per = max(n_read, 1)
    log(f"[bound] {name}: {int(pops.sum()) / per:.3f} pops/ray, {int(tests.sum()) / per:.3f} "
        f"tri tests/ray{'' if n_read == n else f' over {n_read} of {n} rays'}, {ops:.4g} FP32 ops -> {ops_ms:.5f} ms; {nodes} distinct nodes and "
        f"{leaf_rows} distinct {'batches' if mode in ('row', 'stream') else 'slots'} read, "
        f"{nbytes} bytes -> {bytes_ms:.5f} ms")
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def phase_frame(scene, backend, cfg, dev, errs):
    n = WIDTH * HEIGHT
    chunks = backend.chunks
    reset_launches()
    with Recorder() as rec:
        img = render(scene, cfg, device=dev, backend=backend)
        torch.cuda.synchronize()
    counts = launches()
    log(f"[frame] launches {counts} over {len(chunks)} chunks")
    assert counts == only(wide_closest=len(chunks), wide_anyhit=len(chunks)), counts
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
    seen_c, seen_a = [], []
    err_c, pops_c, tests_c, plain_c, _ = check_closest(o, d, chunks, t_far, "frame primary",
                                                       seen=seen_c)
    err_a, pops_a, tests_a, plain_a, _ = check_anyhit(so, sd, chunks, stf, "frame shadow",
                                                      seen=seen_a)
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

    rows = []
    for name, pops, tests, plain_ms, seen, tf, hits in (
        ("wide_closest", pops_c, tests_c, plain_c, seen_c, t_far, int((prim >= 0).sum())),
        ("wide_anyhit", pops_a, tests_a, plain_a, seen_a, stf, 0),
    ):
        bound, by = wide_bound(name, chunks, "group", seen, pops, tests, n, tf is not None, hits)
        facts = wide_kernel_facts(name == "wide_anyhit")
        before = PR5_MS[name][0]
        log(f"[bound] {name}: kernel {kern_ms[name]:.4f} ms = {bound / kern_ms[name]:.4f} "
            f"of the bound; PR 5's kernel {before} ms (PERF.md, {bound / before:.4f} of the "
            f"bound), {before / kern_ms[name]:.3f}x this run's; {facts}")
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES,
            "launches": counts[name], "max_abs_err": errs[name],
            "ms": kern_ms[name], "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None, **facts,
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
    ops = [(e.self_device_time_total, e) for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU and e.self_device_time_total > 0]
    log(f"[profile] {label}: device time by the torch op that launched it")
    for us, e in sorted(ops, key=lambda p: -p[0])[:10]:
        log(f"[profile]   {us / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def primary_rays(scene, size: int, dev, jitter: bool = True):
    """The size x size frame's primary rays of sample 0, in tile order."""
    tile = render_api._tile_shape(size, size)
    pid = render_api.tile_pixel_ids(size, size, *tile, device=dev) if tile else None
    o, d, _ = generate_rays(scene.camera, size, size, sampler.seed_key(0, dev), 0,
                            jitter, pixel_id=pid)
    return o.contiguous(), d.contiguous()


def check_sphere(o, d, center, radius, caps, label):
    """The sphere kernel against its plain version, and its merged entry
    (sphere_merge, on hits of each kind) against sphere_merge_plain;
    returns (max |t| error, prim)."""
    t_k, p_k = ks.sphere_pass(o, d, center, radius, T_MIN, caps)
    t_p, p_p = ks.sphere_pass_plain(o, d, center, radius, T_MIN, caps)
    idx = torch.arange(o.shape[0], device=o.device, dtype=torch.int32)
    merged = ks.sphere_merge(o, d, center, radius, T_MIN, caps, idx % 3, idx * 7)
    ref = ks.sphere_merge_plain(o, d, center, radius, T_MIN, caps, idx % 3, idx * 7)
    torch.cuda.synchronize()
    err = (t_k - t_p).abs().max().item()
    same = all(torch.equal(x, y) for x, y in zip(merged, ref))
    log(f"[sphere] {label}: {o.shape[0]} rays, {center.shape[0]} spheres, hit "
        f"{float((t_k < T_MAX).float().mean()):.4f}, max|dt| {err:.3g}, "
        f"prim mismatches {int((p_k != p_p).sum())}; merged entry identical {same}")
    assert torch.equal(p_k, p_p), label
    assert torch.equal(t_k, t_p), (label, err)
    assert same, label
    return err, p_k


def phase_sphere_parity(dev, size: int = 256, n_random: int = SUBSET, big: int = 1 << 20):
    """The kernel against its plain version on Cornell's primary rays and
    random rays, with 8, 64 and twice 8 spheres, caps of T_MAX, finite
    values and 0 in turn. Returns the max |t| error and the 8-sphere case
    (o, d, caps, center, radius) repeated to `big` rays, for row 8's
    times."""
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
    reps = -(-big // m)
    tile = lambda x: x.repeat((reps,) + (1,) * (x.dim() - 1))[:big].contiguous()  # noqa: E731
    return err, (tile(o), tile(d), tile(caps), c8, r8)


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
    assert counts == only(wide_closest=1, wide_anyhit=scene.n_lights, sphere_merge=1,
                          sphere_pass=scene.n_lights), counts
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


def phase_config3(dev, big, steps: int = 10, size: int | None = None):
    """Config 3 (Cornell 256x256, backend 'pallas'): render_grad and fit on
    the card through the wide walks and the sphere kernel (sphere_merge in
    each closest hit, sphere_pass in each occlusion test). Returns the
    sphere kernel's rows of the kernels line (sphere_rows; `big` is phase
    2's case repeated to size)."""
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
    assert counts == only(wide_closest=renders, wide_anyhit=renders,
                          sphere_merge=renders, sphere_pass=renders), counts
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

    # The kernels on the path's own inputs: every recorded call against the
    # plain version, bit for bit.
    errs = {}
    for name, plain in (("sphere_pass", ks.sphere_pass_plain),
                        ("sphere_merge", ks.sphere_merge_plain)):
        errs[name] = 0.0
        for o, d, c, r, t_min, t_in, out in rec.calls[name]:
            ref = plain(o, d, c, r, t_min, *(t_in if name == "sphere_merge" else (t_in,)))
            assert all(torch.equal(x, y) for x, y in zip(out, ref)), name
            errs[name] = max(errs[name], max_abs_err(out[0], ref[0]))
    log(f"[config3] {len(rec.calls['sphere_pass'])} sphere_pass and "
        f"{len(rec.calls['sphere_merge'])} sphere_merge calls identical to the plain versions")
    return sphere_rows(rec, counts, errs, big)


#: The sphere pass on its first design (this script's run on an H100 80GB
#: HBM3 at 700 W, PERF.md §6, row 8): the kernel's device time a launch and
#: the wrapper call at config 3's 65,536 rays, when the wrapper built an
#: (S, 4) table with torch.cat and kernels/api.py merged the hit in five
#: more launches. For the log only.
FIRST_SPHERE_MS = {"kernel": 0.002843, "wrapper": 0.04293}


def sphere_rows(rec, counts, errs, big) -> list:
    """Row 8's measurements, on the first recorded call of each entry
    (config 3's 65,536 rays) and on `big`, phase 2's rays repeated to
    1,048,576: (i) the kernels' device time a launch; (ii) the empty
    build's (the same grid, no work: the floor); (iii) the wrapper calls'
    times by CUDA events, and the device time of the launches the caller
    made around the kernel before the merge moved into it (the compare and
    three selects of a closest hit; the table's torch.cat). Returns the
    rows of sphere_pass and sphere_merge."""
    o, d, c, r, t_min, (t, kind, prim), _ = rec.calls["sphere_merge"][0]
    so, sd, sc, sr, s_tmin, tf, _ = rec.calls["sphere_pass"][0]
    empty = ks._lib(ks.EMPTY_DEFINES)
    bo, bd, bcaps, bc, br = big
    calls = {
        "sphere_merge": (lambda: ks.sphere_merge(o, d, c, r, t_min, t, kind, prim),
                         lambda: ks.sphere_merge_plain(o, d, c, r, t_min, t, kind, prim)),
        "sphere_pass": (lambda: ks.sphere_pass(so, sd, sc, sr, s_tmin, tf),
                        lambda: ks.sphere_pass_plain(so, sd, sc, sr, s_tmin, tf)),
    }
    s_t, s_prim = ks.sphere_pass(o, d, c, r, t_min, t)

    def caller_merge():  # the merge as separate launches after the pass
        return ks.merge_hit(s_t, s_prim, t, kind, prim)

    chains = {
        "the caller's merge (a compare, three selects)": caller_merge,
        "the table's torch.cat": lambda: torch.cat([c, r[:, None]], dim=1).contiguous(),
        "sphere_pass and the caller's merge": lambda: (ks.sphere_pass(o, d, c, r, t_min, t),
                                                       caller_merge()),
    }
    for label, fn in chains.items():
        ms, k = device_time(fn, 100)
        log(f"[config3] {label}: {k:g} launches, {ms:.6f} ms of device time a call, "
            f"{events_ms(fn, 100):.5f} ms a call by CUDA events")
    floor = {}
    for label, args in (("config 3's", (o, d, c, r, t_min, t)),
                        ("phase 2's rays repeated to", (bo, bd, bc, br, T_MIN, bcaps))):
        n = args[0].shape[0]
        got, ref = ks.sphere_pass(*args), ks.sphere_pass_plain(*args)
        assert all(torch.equal(x, y) for x, y in zip(got, ref)), label
        ms, _ = device_time(lambda: ks._kernel(*args), 100, "sphere_pass_kernel")
        floor[n], _ = device_time(lambda: ks._kernel(*args, lib=empty), 100,
                                  "sphere_pass_kernel")
        assert ms > 0 and floor[n] > 0, "the profiler saw no sphere_pass_kernel"
        bytes_ms = (n * 36 + c.shape[0] * 16) / PEAK_BYTES * 1e3
        log(f"[config3] sphere_pass_kernel at {label} {n} rays: {ms:.6f} ms a launch on the "
            f"device (bytes bound {bytes_ms:.6f} ms), identical to the plain version; the "
            f"empty kernel on the same grid ({-(-n // 256)} blocks of 256): {floor[n]:.6f} ms")
    rows = []
    for name, (call, plain) in calls.items():
        merge = name == "sphere_merge"
        n, s = (o if merge else so).shape[0], c.shape[0]
        call_ms = events_ms(call, 100)
        ms, _ = device_time(call, 100, "sphere_pass_kernel")
        assert ms > 0, f"the profiler saw no launch of {name}"
        plain_ms = events_ms(plain, 5)
        facts = ks.kernel_attributes(merge)
        [spill] = [v for k, v in _build.ptxas_spills(_build.log_path("sphere_pass").read_text())
                   .items() if f"18sphere_pass_kernelILb{int(merge)}E" in k]
        nbytes = n * (48 if merge else 36) + s * 16
        ops = n * s * OPS_SPHERE
        ops_ms, bytes_ms = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
        log(f"[config3] {name}: {call_ms:.5f} ms a wrapper call (CUDA events over 100 calls, "
            f"the host's launch overhead included; the first design's sphere_pass "
            f"{FIRST_SPHERE_MS['wrapper']} ms), kernel {ms:.6f} ms a launch on the device "
            f"(torch.profiler; the first design's {FIRST_SPHERE_MS['kernel']} ms), "
            f"{ms - floor[n]:.6f} ms over the empty kernel; {facts}, spills {spill} bytes")
        log(f"[bound] {name}: {n} rays x {s} spheres, {ops} FP32 ops -> {ops_ms:.5f} ms, "
            f"{nbytes} bytes -> {bytes_ms:.5f} ms; kernel {ms:.6f} ms, plain {plain_ms:.4f} ms, "
            f"{max(ops_ms, bytes_ms) / ms:.4f} of the bound")
        rows.append({
            "name": name, "route": "cuda", "source": SPHERE_SOURCE,
            "replaces": SPHERE_REPLACES, "launches": counts[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None, "registers": facts["registers"], "spill_bytes": spill,
            "local_bytes": facts["local_bytes"], "warps_per_sm": facts["warps_per_sm"],
        })
    return rows


def device_time(fn, reps: int, name: str = ""):
    """(device milliseconds, launches) a call of fn, over `reps` calls
    (torch.profiler), of the kernels whose name holds `name` (all kernels
    by default)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key]
    return (sum(e.device_time_total for e in evs) / 1e3 / reps,
            sum(e.count for e in evs) / reps)


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


def phase_fwd_bwd(scene, backend, dev, size: int = WIDTH) -> dict:
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
    assert counts == only(wide_closest=n_chunks, wide_anyhit=n_chunks), counts
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
    return {"fwd_ms": mf, "materials_ms": mm, "geometry_ms": mg}


# ------------------------------------------------------- the bench harness


#: Calls of fn in the harness's _time_sustained (a warmup, then 3 batches of
#: 5) and _time (a warmup, then 3), at their defaults.
SUSTAINED_CALLS = 1 + 3 * 5
BLOCKED_CALLS = 1 + 3
#: The headline's result keys (bench.py's, with fwd_bwd's; bwd_guard only
#: on a breach) and its detail's.
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline", "detail", "rays_per_s_fwd_bwd",
                 "rays_per_s_fwd_frame", "bwd_over_fwd_geometry"}
DETAIL_KEYS = {"platform", "n_triangles", "image", "wall_s", "hit_fraction", "n_chunks",
               "roofline", "fwd_bwd", "grad_allclose", "config4", "config5_unit", "scaling"}
#: fit on the card, 4 steps against 2 + a resume for 2: the backward's
#: index_add_ sums in the order its atomics land, so the two runs agree to
#: f32 rounding of the gradients, not bit for bit.
RESUME_RTOL = 1e-5


class forbid_plain:
    """Make every plain walk and plain sphere pass raise: inside, a call
    that reached one instead of its kernel fails."""

    SITES = ((tw, "_walk_plain"), (tp, "_closest_plain"), (tp, "_anyhit_plain"),
             (ks, "sphere_pass_plain"), (ks, "sphere_merge_plain"))

    def __enter__(self):
        self._orig = [getattr(m, n) for m, n in self.SITES]

        def refuse(*a, **k):
            raise AssertionError("a plain version ran where its kernel should have")

        for m, n in self.SITES:
            setattr(m, n, refuse)
        return self

    def __exit__(self, *exc):
        for (m, n), f in zip(self.SITES, self._orig):
            setattr(m, n, f)


def numbers(x, path=""):
    """(path, value) of every number in a nested dict or list."""
    if isinstance(x, dict):
        for k, v in x.items():
            yield from numbers(v, f"{path}.{k}")
    elif isinstance(x, list):
        for i, v in enumerate(x):
            yield from numbers(v, f"{path}[{i}]")
    elif isinstance(x, (int, float)) and not isinstance(x, bool):
        yield path, x


def phase_bench(scene, backend, dev, size: int = WIDTH) -> dict:
    """The headline (blink_torch.benchmarks.headline) stage by stage on the
    prebuilt scene and backend, each stage's launches asserted and no plain
    walk allowed; its JSON line printed. Then run_bench of cornell and fit
    through pallas, and the tooling on the card. Returns the headline's
    result."""
    from blink_torch.benchmarks import harness
    from blink_torch.benchmarks import headline as hl

    t0 = time.perf_counter()
    n = len(backend.chunks)
    calls = []
    walk = tw.traverse_closest_wide

    def counted(*a, **k):
        calls.append(1)
        return walk(*a, **k)

    tw.traverse_closest_wide = counted
    try:
        with forbid_plain():
            reset_launches()
            result = hl.headline(scene, size, backend, dev)
            torch.cuda.synchronize()
            counts = launches()
    finally:
        tw.traverse_closest_wide = walk
    log(f"[bench] primary traversal: {len(calls)} calls, launches {counts}")
    assert len(calls) == SUSTAINED_CALLS + BLOCKED_CALLS + 1, len(calls)
    assert counts == only(wide_closest=len(calls) * n), counts
    expect = {
        "grad_allclose": only(),  # Cornell through brute: no kernel
        "fwd_bwd": only(wide_closest=3 * SUSTAINED_CALLS * n,
                        wide_anyhit=3 * SUSTAINED_CALLS * n),
        # the sponza preset's path integrator, depth 4, deterministic: each
        # bounce's closest hit, and a shadow ray to each of the 2 light
        # triangles, through bvh's one chunk
        "scaling": only(skip_closest=4 * BLOCKED_CALLS, skip_anyhit=2 * 4 * BLOCKED_CALLS),
        "config4": only(wide_closest=SUSTAINED_CALLS * 4 * n,
                        wide_anyhit=SUSTAINED_CALLS * 4 * n),
        "config5_unit": only(wide_closest=SUSTAINED_CALLS * 4 * n,
                             wide_anyhit=SUSTAINED_CALLS * 4 * n),
    }
    detail = result["detail"]
    for name, _, fn in hl.stages(result, scene, size, backend, dev):
        ts = time.perf_counter()
        with forbid_plain():
            reset_launches()
            detail[name] = fn()
            torch.cuda.synchronize()
            counts = launches()
        log(f"[bench] {name} ({time.perf_counter() - ts:.1f} s): {json.dumps(detail[name])}")
        log(f"[bench] {name} launches {counts}")
        assert counts == expect[name], (name, counts)
    print(json.dumps(result), flush=True)
    assert HEADLINE_KEYS <= set(result) and set(detail) == DETAIL_KEYS, (set(result),
                                                                          set(detail))
    assert result["metric"] == "primary_rays_per_sec_fwd_1mtri"
    assert detail["grad_allclose"]["pass"], detail["grad_allclose"]
    for path, v in numbers(result):
        # grad_allclose's indices and gradients are an index set and signed
        signed = path.startswith((".detail.grad_allclose.indices", ".detail.grad_allclose.grads"))
        assert np.isfinite(v) and (signed or v > 0), (path, v)
    log(f"[bench] headline {result['value']:.6g} rays/s ({detail['wall_s'] * 1e3:.4f} ms a "
        f"call at {size}x{size}, {detail['n_chunks']} chunks), hit fraction "
        f"{detail['hit_fraction']:.4f}; {detail['roofline']['pops_per_ray']:.3f} pops and "
        f"{detail['roofline']['tests_per_ray']:.3f} tests a ray; copy bandwidth "
        f"{detail['roofline']['hbm_gbps_measured']:.1f} GB/s; "
        f"{detail['roofline']['fraction_of_sol']:.4f} of the per-ray bound with no cache "
        "reuse (the kernels line's bound_ms counts distinct bytes)")

    for config in ("cornell", "fit"):
        with forbid_plain():
            reset_launches()
            out = harness.run_bench(config, quick=True, device=dev, backend="pallas")
            torch.cuda.synchronize()
            counts = launches()
        calls = 2 * BLOCKED_CALLS  # forward, then fwd+bwd: one closest hit, one shadow ray
        log(f"[bench] run_bench({config!r}, quick, pallas): {json.dumps(out)}")
        log(f"[bench] run_bench({config!r}) launches {counts}")
        assert counts == only(wide_closest=calls, wide_anyhit=calls, sphere_merge=calls,
                              sphere_pass=calls), counts
        # the roofline's work, counted on this config's own primary rays
        assert out["roofline"]["pops_per_ray"] > 0 < out["roofline"]["tests_per_ray"], out
    tooling_on_card(scene, backend, dev)
    log(f"[bench] phase {time.perf_counter() - t0:.1f} s")
    return result


def tooling_on_card(scene, backend, dev) -> None:
    """Checkpoints, resume, refit_bvh and trace() on the card. Whatever it
    writes goes under build/smoke (ignored by git)."""
    from blink_torch.bvh.build import build_flat_bvh, refit_bvh
    from blink_torch.ckpt import load_ckpt, save_ckpt
    from blink_torch.obs.profile import trace

    out_dir = os.path.join(ROOT, "build", "smoke")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()

    def adam_after_a_step(x):
        p = {"albedo": x.requires_grad_(True)}
        opt = torch.optim.Adam(list(p.values()), lr=1e-2)
        (p["albedo"] ** 2).sum().backward()
        opt.step()
        return p, opt

    p, opt = adam_after_a_step(torch.rand(10, 3, device=dev))
    ck = os.path.join(out_dir, "ckpt.safetensors")
    save_ckpt(ck, 3, p, opt.state_dict())
    _, like = adam_after_a_step(torch.zeros(10, 3, device=dev))
    step, got, st = load_ckpt(ck, {"albedo": torch.zeros(10, 3, device=dev)}, like.state_dict())
    assert step == 3 and torch.equal(got["albedo"], p["albedo"].detach())
    assert all(torch.equal(st["state"][0][f], v) for f, v in opt.state_dict()["state"][0].items())
    log(f"[tooling] checkpoint of CUDA tensors loaded back equal ({got['albedo'].device})")

    cfg = get_config("fit").override(width=64, height=64, deterministic=True, backend="pallas")
    cornell = build_scene(cfg).to(dev)
    target = render(cornell, cfg, device=dev)
    a = cornell.materials.albedo
    noise = torch.from_numpy(np.random.default_rng(3).random(tuple(a.shape), dtype=np.float32))
    scene0 = cornell.replace(materials=cornell.materials.replace(
        albedo=torch.clamp(a + 0.2 * noise.to(dev), 0.05, 0.95)))
    kw = dict(lr=1e-2, optimize=("albedo",), log_path=os.path.join(out_dir, "fit.jsonl"))
    whole, h = fit(scene0, target, cfg, FitConfig(steps=4, **kw), device=dev)
    ck = os.path.join(out_dir, "fit.safetensors")
    _, h1 = fit(scene0, target, cfg, FitConfig(steps=2, ckpt_every=2, ckpt_path=ck, **kw),
                device=dev)
    resumed, h2 = fit(scene0, target, cfg, FitConfig(steps=4, **kw), device=dev, resume_from=ck)
    loss_d = max(abs(x - y) / abs(y) for x, y in zip(h1 + h2, h))
    par_d = (resumed.materials.albedo - whole.materials.albedo).abs().max().item()
    log(f"[tooling] fit 4 steps against 2 + resume 2 (Cornell 64x64, pallas): losses "
        f"{h} and {h1 + h2}, largest relative difference {loss_d:.3g}; albedo largest "
        f"difference {par_d:.3g} (tolerance rtol {RESUME_RTOL})")
    assert len(h2) == 2 and h2[-1] <= h1[0] and loss_d <= RESUME_RTOL
    assert torch.allclose(resumed.materials.albedo, whole.materials.albedo, rtol=RESUME_RTOL,
                          atol=RESUME_RTOL)

    tris = scene.triangles
    bvh = build_flat_bvh(tris.verts.cpu().numpy(), tris.idx.cpu().numpy())
    moved = tris.replace(verts=tris.verts + torch.tensor([0.25, -0.5, 1.0], device=dev))
    r_dev = refit_bvh(bvh, moved)
    r_cpu = refit_bvh(bvh, moved.to("cpu"))
    for f in ("lo", "hi", "tv0", "te1", "te2"):
        got = getattr(r_dev, f)
        assert got.device == dev and torch.equal(got.cpu(), getattr(r_cpu, f)), f
    log(f"[tooling] refit_bvh of {scene.n_triangles} triangles ({bvh.n_nodes} nodes) on the "
        "card equal to the CPU's")

    fcfg = get_config("sponza").override(width=WIDTH, height=HEIGHT, spp=1,
                                         integrator="direct", backend="pallas")
    names = ("albedo", "emission", "tri_verts")
    zero = torch.zeros((HEIGHT, WIDTH, 3), device=dev)
    logdir = os.path.join(out_dir, "trace")
    with trace(logdir) as prof:
        render_grad(scene, fcfg, zero, names, device=dev, backend=backend)
        torch.cuda.synchronize()
    files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    kernels = sorted({e.key for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA})
    walks = [k for k in kernels if "wide_group_walk" in k]
    log(f"[tooling] trace() of one fwd+bwd step: {files} in build/smoke/trace, "
        f"{len(kernels)} kernel names; the walk kernels named: {walks or 'none'}")
    assert files
    log(f"[tooling] {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------- path tracing


#: Every STRIDE-th ray of each config-4 walk call is held to the plain walk
#: (131,072 of a call's 4,194,304; a ray's output does not depend on the
#: other rays), and its counts stand for the call's.
STRIDE = 32


def hold_bounce(any_hit, call, chunks, stride, label, tag):
    """One recorded walk call of the path (o, d, t_far, out) against the
    plain walk on every stride-th ray, dead lanes included, bit for bit.
    Returns the max |error|."""
    o, d, tf, out = call
    sub = torch.arange(0, o.shape[0], stride, device=o.device)
    rays = (o[sub].contiguous(), d[sub].contiguous(), tf[sub].contiguous())
    part = out.index_select(0, sub) if any_hit else (out[0][sub], out[1][sub])
    return hold_to_plain(any_hit, rays, chunks, "group", part, label, tag)[0]


def live_walk(any_hit, call, chunks, label, tag):
    """The plain walk on every live ray (t_far > 0) of a recorded walk call,
    held bit for bit to the kernel's output there. Returns (pops, tests,
    seen marks) of the live rays: the work the call cannot avoid, since a
    dead lane's answer follows from its t_far alone."""
    o, d, tf, out = call
    live = torch.nonzero(tf > 0).squeeze(1)
    rays = tuple(x.index_select(0, live) for x in (o, d, tf))
    part = out.index_select(0, live) if any_hit else tuple(x.index_select(0, live) for x in out)
    _, pops, tests, seen, _ = hold_to_plain(any_hit, rays, chunks, "group", part, label, tag)
    return pops, tests, seen


def path_bounces(rec, chunks, depth: int, stride: int, tag: str, time_reps: int = 3):
    """Each bounce's closest-hit and any-hit call of a recorded path frame:
    held bit for bit to the plain walks on every stride-th ray and on
    every live ray; the live share, pops and tests a live ray, the time of
    the wrapper re-run on the call's full inputs (CUDA events, `time_reps`
    calls) and the bound (PERF.md §6's counting, over the live rays' pops,
    tests, seen marks and o and d). Beside each, the skip walk on the same
    inputs (group's walk without leaf tests): its time, skip/group, and the
    counting builds' pops of both on every lane (group's held ray for ray
    to the plain walk's on the live rays). Returns {name: {"err", "ms",
    "bound_ms"}} summed over the bounces."""
    out = {n: {"err": 0.0, "ms": 0.0, "bound_ms": 0.0} for n in ("wide_closest", "wide_anyhit")}
    assert len(rec.calls["wide_closest"]) == depth and len(rec.calls["wide_anyhit"]) == depth
    for b in range(depth):
        for name in ("wide_closest", "wide_anyhit"):
            any_hit = name == "wide_anyhit"
            call = rec.calls[name][b]
            o, d, tf, res = call
            n = o.shape[0]
            err = hold_bounce(any_hit, call, chunks, stride, f"bounce {b} {name}", tag)
            pops, tests, seen = live_walk(any_hit, call, chunks, f"bounce {b} {name} live", tag)
            ms = events_ms(lambda: walk(any_hit, (o, d, tf), chunks, "group"), time_reps)
            hits = 0 if any_hit else int((res[1] >= 0).sum())
            n_live = pops.numel()
            bound, by = wide_bound(name, chunks, "group", seen, pops, tests, n, True, hits,
                                   n_read=n_live)
            share = n_live / n
            pl = float(pops.sum()) / max(n_live, 1)
            tl = float(tests.sum()) / max(n_live, 1)
            log(f"[{tag}] bounce {b} {name}: {n} rays, live {share:.4f}, "
                f"{pl:.3f} pops and {tl:.3f} tests a live ray (plain walk on all {n_live} "
                f"live rays), {ms:.4f} ms, bound {bound:.5f} ms ({by}), {bound / ms:.4f} of it, "
                f"{ms / max(n_live, 1) * 1e6:.3f} ns a live ray")
            skip_ms = events_ms(lambda: walk(any_hit, (o, d, tf), chunks, "skip"), time_reps)
            _, g_pops, _ = tw.walk_counts(any_hit, o, d, chunks, tf, leaf_mode="group")
            _, s_pops, _ = tw.walk_counts(any_hit, o, d, chunks, tf, leaf_mode="skip")
            assert torch.equal(g_pops[tf > 0], pops), (tag, b, name)
            log(f"[{tag}] bounce {b} {name}: skip {skip_ms:.4f} ms against group's "
                f"{ms:.4f} ms on the same {n} rays (one design): skip/group "
                f"{skip_ms / ms:.3f}, 1 - skip/group {1 - skip_ms / ms:.3f}; skip pops "
                f"{int(s_pops.sum()) / int(g_pops.sum()):.3f}x group's nodes (counting builds)")
            out[name]["err"] = max(out[name]["err"], err)
            out[name]["ms"] += ms
            out[name]["bound_ms"] += bound
    return out


def timed_frames(fn, reps: int = 3) -> list:
    fn()
    return [events_ms(fn, 1) for _ in range(reps)]


def phase_config4(scene, backend, dev, size: int | None = None, stride: int = STRIDE,
                  frames: int = 3):
    """Config 4, the sponza preset uncut (512x512, 16 spp, path depth 4,
    spp_block 16, compact, rr_start 1, stochastic, textured) on the 1M
    scene through the production wide backend: one batch of 16 samples a
    pixel, 4 bounces of 3 + 3 wide launches. Returns the walks' sums for
    rows 1-2 (path_bounces) and the launches, and the frame's mean ms."""
    cfg = get_config("sponza").override(width=size, height=size)
    assert (cfg.spp, cfg.max_depth, cfg.spp_block, cfg.compact, cfg.rr_start) == (16, 4, 16, True, 1)
    samples = cfg.width * cfg.height * cfg.spp
    n_chunks = len(backend.chunks)
    reset_launches()
    with Recorder() as rec:
        img = render(scene, cfg, device=dev, backend=backend)
        torch.cuda.synchronize()
    counts = launches()
    log(f"[config4] sponza preset {cfg.width}x{cfg.height}, {cfg.spp} spp, depth {cfg.max_depth}, "
        f"spp_block {cfg.spp_block}, compact, rr_start {cfg.rr_start}: launches {counts}")
    walks = cfg.max_depth * n_chunks
    assert counts == only(wide_closest=walks, wide_anyhit=walks), counts
    assert all(c[0].shape[0] == samples for c in rec.calls["wide_closest"])  # one batch
    img_np = img.cpu().numpy()
    assert img_np.shape == (cfg.height, cfg.width, 3) and np.isfinite(img_np).all()
    assert (img_np >= 0).all() and img_np.mean() > 0
    sums = path_bounces(rec, backend.chunks, cfg.max_depth, stride, "config4")
    del rec

    img_plain = render(scene, cfg.override(compact=False), device=dev, backend=backend)
    log(f"[config4] image mean {img_np.mean():.6f}; without compaction identical "
        f"{torch.equal(img_plain, img)}")
    assert torch.equal(img_plain, img)
    del img_plain

    frame = lambda: render(scene, cfg, device=dev, backend=backend)  # noqa: E731
    t = timed_frames(frame, frames)
    mean = sum(t) / len(t)
    torch.cuda.reset_peak_memory_stats()
    frame()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    walk_ms = sums["wide_closest"]["ms"] + sums["wide_anyhit"]["ms"]
    log(f"[config4] frame ms {[round(x, 3) for x in t]}: mean {mean:.3f}, min {min(t):.3f}, "
        f"max {max(t):.3f}; {samples / mean * 1e3:.5g} camera samples/s; walks {walk_ms:.3f} ms "
        f"({walk_ms / mean:.4f} of the frame); peak memory {peak} bytes")
    profile(frame, "config4 frame", mean)
    for v in sums.values():
        v["launches"] = walks
    return sums, mean


def phase_config5(scene, backend, dev, width: int | None = None, height: int = 512,
                  stride: int = STRIDE):
    """Config 5's per-card unit as bench.py defines it: the pod preset at
    4096x512 and 1 spp (the per-sample loop), path depth 4, compact,
    rr_start 1; the first bounce's walks held to their plain versions on
    every stride-th ray."""
    cfg = get_config("pod").override(spp=1, height=height, width=width)
    samples = cfg.width * cfg.height
    n_chunks = len(backend.chunks)
    reset_launches()
    with Recorder() as rec:
        img = render(scene, cfg, device=dev, backend=backend)
        torch.cuda.synchronize()
    counts = launches()
    log(f"[config5] pod unit {cfg.width}x{cfg.height}, {cfg.spp} spp, depth {cfg.max_depth}: "
        f"launches {counts}")
    walks = cfg.max_depth * n_chunks
    assert counts == only(wide_closest=walks, wide_anyhit=walks), counts
    img = img.cpu().numpy()
    assert img.shape == (cfg.height, cfg.width, 3) and np.isfinite(img).all()
    assert (img >= 0).all() and img.mean() > 0
    for name in ("wide_closest", "wide_anyhit"):
        call = rec.calls[name][0]
        hold_bounce(name == "wide_anyhit", call, backend.chunks, stride, f"bounce 0 {name}",
                    "config5")
    del rec
    t = timed_frames(lambda: render(scene, cfg, device=dev, backend=backend))
    mean = sum(t) / len(t)
    log(f"[config5] frame ms {[round(x, 3) for x in t]}: mean {mean:.3f}, min {min(t):.3f}, "
        f"max {max(t):.3f}; {samples / mean * 1e3:.5g} camera samples/s; image mean "
        f"{img.mean():.6f}")


# ------------------------------------------------------- leaf modes


#: The layouts of [leafmode], each (chunks, build_chunked_wide's arguments
#: from the camera origin, leaf schedules walked, rows reported): (a)
#: benchmarks/leafmode_probe.py's, the leaf-mode A/B at the metric of
#: record's scale (150k-triangle chunks, wide leaves of 44, quantized
#: boxes, row tables, near to far); (b) build_chunked_wide's own defaults
#: (120k-triangle chunks, wide leaves of 32, f32 boxes, row tables), the
#: layout of blink's interpret tests; (c) layout (a) with f32 boxes, the
#: same trees, so that (c) against (a) is the cost of decoding quantized
#: boxes against reading f32 ones, with and without the leaf tests.
LEAFMODE_LAYOUTS = {
    "a": (7, lambda cam: dict(chunk_tris=150_000, wide_leaf=44, quant=True,
                              row_tables=True, order_from=cam), tw.LEAF_MODES, True),
    "b": (9, lambda cam: {}, tw.LEAF_MODES, True),
    "c": (7, lambda cam: dict(chunk_tris=150_000, wide_leaf=44, quant=False,
                              row_tables=True, order_from=cam), ("group", "skip"), False),
}


def walk(any_hit, rays, chunks, mode):
    """One wrapper call of the wide walk under leaf schedule `mode`."""
    o, d, tf = rays
    if any_hit:
        return tw.traverse_anyhit_wide(o, d, chunks, tf, leaf_mode=mode)
    return tw.traverse_closest_wide(o, d, chunks, t_far=tf, leaf_mode=mode)


def hold_to_plain(any_hit, rays, chunks, mode, out, label, tag: str = "leafmode"):
    """A wide walk's output `out` on `rays` (o, d, t_far) against its plain
    version under the same leaf schedule, bit for bit: t and prim, or the
    blocked flags. Returns (max |error|, pops, tests, seen marks, plain
    ms of the counted call)."""
    o, d, tf = rays
    seen = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if any_hit:
        ref, pops, tests = tw.anyhit_wide_plain(o, d, chunks, tf, counts=True,
                                                leaf_mode=mode, seen=seen)
        same = torch.equal(out, ref)
    else:
        t, prim, pops, tests = tw.closest_wide_plain(o, d, chunks, t_far=tf, counts=True,
                                                     leaf_mode=mode, seen=seen)
        ref = (t, prim)
        same = torch.equal(out[0], t) and torch.equal(out[1], prim)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max_abs_err(out, ref)
    assert same, (label, err)
    what = (f"blocked {float(out.float().mean()):.4f}" if any_hit
            else f"hit {float((out[1] >= 0).float().mean()):.4f}")
    log(f"[{tag}] {label}: {o.shape[0]} rays, {what}, identical to the plain walk "
        f"(max|d| {err:.3g}), plain {plain_ms:.1f} ms")
    return err, pops, tests, seen, plain_ms


def check_wide_counts(any_hit, rays, chunks, mode, out, pops, tests, label) -> None:
    """The counting build of the wide walk (`mode`) on `rays`: its output
    equal to the kernel's `out`, and each ray's pops and tests equal to the
    plain walk's `pops` and `tests`."""
    o, d, tf = rays
    got, p, q = tw.walk_counts(any_hit, o, d, chunks, tf, leaf_mode=mode)
    same_out = (torch.equal(got, out) if any_hit
                else torch.equal(got[0], out[0]) and torch.equal(got[1], out[1]))
    assert same_out, label
    assert torch.equal(p, pops) and torch.equal(q, tests), (
        label, int((p != pops).sum()), int((q != tests).sum()))
    log(f"[leafmode] {label}: the counting build's pops and tests equal the plain walk's, "
        f"ray for ray (a ray: {pops.double().mean().item():.3f} pops, "
        f"{tests.double().mean().item():.3f} tests)")


def phase_leafmode(scene, backend, cfg, dev, size: int = WIDTH):
    """Every leaf schedule and child-box layout of the wide walk on Sponza
    1M, over the layouts of LEAFMODE_LAYOUTS and the size x size frame's
    primary rays and their shadow rays: each variant once through its
    wrapper (the counts), row and stream against group bit for bit, skip
    missing everything, group against the production walk; each output
    against its plain version, bit for bit, with the counts and seen marks
    for its bound; the counting build ray for ray (every schedule); the
    times, registers, spills and warps, and each schedule's time against
    group's on one design. Then three frames through render()
    under BLINK_LEAF_MODE=group|row|stream on layout (a): each frame's
    closest- and any-hit calls against the plain versions bit for bit, the
    images alike. Returns the rows of the new variants."""
    cam = scene.camera.origin.detach().cpu().numpy().astype(np.float32)
    o, d = primary_rays(scene, size, dev)
    t_prod, p_prod = tw.traverse_closest_wide(o, d, backend.chunks)
    so, sd, stf = short_shadow_rays(o, d, t_prod, p_prod, scene)
    b_prod = tw.traverse_anyhit_wide(so, sd, backend.chunks, stf)
    rays = {False: (o, d, None), True: (so, sd, stf)}
    n = o.shape[0]
    rows, layouts, times, pops_a_ray = [], {}, {}, {}
    for lay, (n_chunks, kw, modes, report) in LEAFMODE_LAYOUTS.items():
        t0 = time.perf_counter()
        host = tw.build_chunked_wide(scene.triangles, **kw(cam))
        chunks = [tw.WideChunk.from_host(c, dev) for c in host]
        quant = chunks[0].quant
        log(f"[leafmode] layout ({lay}): {len(chunks)} chunks, {host[0].n_wide} wide nodes "
            f"and {host[0].tbat.shape[0]} batches a chunk, wide leaf {host[0].leaf_size}, "
            f"{'quantized' if quant else 'f32'} boxes, built in {time.perf_counter() - t0:.1f} s")
        assert len(chunks) == n_chunks and all(c.tbat is not None for c in chunks)
        layouts[lay] = chunks

        # The path: each variant once at full size through its wrapper,
        # with the counts set to 0 just before and read just after.
        reset_launches()
        out = {(a, mo): walk(a, rays[a], chunks, mo) for mo in modes for a in (False, True)}
        torch.cuda.synchronize()
        counts = launches()
        log(f"[leafmode] ({lay}) launches {counts}")
        assert counts == only(**{tw.launch_name(a, mo, quant): n_chunks
                                 for a in (False, True) for mo in modes}), counts
        for mo in set(modes) & {"row", "stream"}:
            assert torch.equal(out[(False, mo)][0], out[(False, "group")][0]), (lay, mo)
            assert torch.equal(out[(False, mo)][1], out[(False, "group")][1]), (lay, mo)
            assert torch.equal(out[(True, mo)], out[(True, "group")]), (lay, mo)
        assert (out[(False, "skip")][1] == -1).all() and not out[(True, "skip")].any()
        t_g, p_g = out[(False, "group")]
        ties = compare_with_wide(t_g, p_g, t_prod, p_prod, "leafmode")
        mism = int((out[(True, "group")] != b_prod).sum())
        same = "row and stream identical to group, " if "row" in modes else ""
        log(f"[leafmode] ({lay}) {n} rays: {same}skip misses all; group against production: "
            f"{ties} prim ties, any hit {mism} mismatches")
        assert mism == 0

        for mo in modes:
            for a in (False, True):
                name = tw.launch_name(a, mo, quant)
                label = f"{name} ({lay}) {'shadow' if a else 'primary'}"
                err, pops, tests, seen, plain_ms = hold_to_plain(a, rays[a], chunks, mo,
                                                                 out[(a, mo)], label)
                ms = events_ms(lambda: walk(a, rays[a], chunks, mo), 5)
                times[(lay, name)] = ms
                hits = 0 if a else int((out[(a, mo)][1] >= 0).sum())
                bound, by = wide_bound(name, chunks, mo, seen, pops, tests, n,
                                       rays[a][2] is not None, hits)
                pops_a_ray[(lay, name)] = pops.double().mean().item()
                check_wide_counts(a, rays[a], chunks, mo, out[(a, mo)], pops, tests, label)
                facts = wide_kernel_facts(a, mo, quant)
                before = (f" (the first design: {FIRST_SKIP_MS[lay][a]} ms)"
                          if mo == "skip" else "")
                log(f"[leafmode] {name} ({lay}): {ms:.4f} ms at {n} rays over {n_chunks} "
                    f"chunks{before}, {bound / ms:.4f} of the bound; {facts}")
                if not report or (mo, quant) == ("group", True):
                    continue  # (c) is a measurement; group+quantized is rows 1-2
                rows.append({
                    "name": name, "route": "cuda", "source": SOURCE,
                    "replaces": f"{REPLACES} (leaf_mode='{mo}', quant={quant})",
                    "launches": counts[name],
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": by, "library_ms": None, **facts,
                })
    for lay in ("a", "b", "c"):
        quant = layouts[lay][0].quant

        def ratio(table, a, mo):
            return table[(lay, tw.launch_name(a, mo, quant))] / table[
                (lay, tw.launch_name(a, "group", quant))]

        for mo in LEAFMODE_LAYOUTS[lay][2][1:]:
            log(f"[leafmode] ({lay}) {mo} against group (one design): closest "
                f"{ratio(times, False, mo):.3f}, any hit {ratio(times, True, mo):.3f}")
        log(f"[leafmode] ({lay}) the leaf tests' share of a group walk, 1 - skip/group: "
            f"closest {1 - ratio(times, False, 'skip'):.3f}, any hit "
            f"{1 - ratio(times, True, 'skip'):.3f}; skip pops {ratio(pops_a_ray, False, 'skip'):.3f}x "
            f"and {ratio(pops_a_ray, True, 'skip'):.3f}x group's nodes, so at equal cost a pop "
            f"this is a lower bound")
    log("[leafmode] (a) group against PR 5's kernel (PERF.md): " + ", ".join(
        f"{base} {times[('a', tw.launch_name(a, 'group', True))]:.4f} against "
        f"{PR5_MS[base][1]} ms, {PR5_MS[base][1] / times[('a', tw.launch_name(a, 'group', True))]:.3f}x"
        for a, base in ((False, "wide_closest"), (True, "wide_anyhit"))))
    for mo in ("group", "skip"):
        log(f"[leafmode] the same trees, f32 (c) against quantized (a) boxes, {mo}: "
            + ", ".join(f"{base} {times[('c', tw.launch_name(a, mo, False))]:.4f} against "
                        f"{times[('a', tw.launch_name(a, mo, True))]:.4f} ms"
                        for a, base in ((False, "closest"), (True, "any hit"))))

    # render() through a wide Backend on layout (a), under each override;
    # each frame's walks against their plain versions on their own rays.
    chunks_a = layouts["a"]
    wide_a = kapi.Backend(name="wide", chunks=chunks_a, shade=backend.shade)
    n_a = LEAFMODE_LAYOUTS["a"][0]
    images = {}
    try:
        for mo in ("group", "row", "stream"):
            os.environ["BLINK_LEAF_MODE"] = mo
            reset_launches()
            with Recorder() as rec:
                images[mo] = render(scene, cfg, device=dev, backend=wide_a)
                torch.cuda.synchronize()
            counts = launches()
            assert counts == only(**{tw.launch_name(False, mo, True): n_a,
                                     tw.launch_name(True, mo, True): n_a}), counts
            (fo, fd, ftf, fout), = rec.calls["wide_closest"]
            (ao, ad, atf, aout), = rec.calls["wide_anyhit"]
            hold_to_plain(False, (fo, fd, ftf), chunks_a, mo, fout, f"render {mo} (a) primary")
            hold_to_plain(True, (ao, ad, atf), chunks_a, mo, aout, f"render {mo} (a) shadow")
            frame_ms = events_ms(lambda: render(scene, cfg, device=dev, backend=wide_a), 1)
            log(f"[leafmode] render BLINK_LEAF_MODE={mo} on (a): launches {counts}, "
                f"a frame {frame_ms:.3f} ms")
        os.environ["BLINK_LEAF_MODE"] = "row"
        reset_launches()
        render(scene, cfg, device=dev, backend=backend)
        torch.cuda.synchronize()
        counts = launches()
    finally:
        os.environ.pop("BLINK_LEAF_MODE", None)
    log(f"[leafmode] render BLINK_LEAF_MODE=row on the production backend: launches {counts}")
    assert counts == only(wide_closest=len(backend.chunks), wide_anyhit=len(backend.chunks))
    assert torch.equal(images["row"], images["group"])
    assert torch.equal(images["stream"], images["group"])
    log(f"[leafmode] the three frames are identical (image mean "
        f"{images['group'].mean().item():.5f})")
    return rows


# ------------------------------------------------------- binary walks


def walked_table_bytes(seen, ordered: bool) -> tuple:
    """(bytes, nodes, slots) of the tables a binary walk cannot avoid
    reading, from the plain version's `seen` masks: the box (24 B) and the
    ints (skip, first, count: 12 B; the ordered walk first, count, rchild,
    axis, lower_first: 20 B) of each node some ray visited, and v0/e1/e2
    (36 B) of each triangle slot some ray tested, each once."""
    nodes = sum(int(m.sum()) for m, _ in seen)
    slots = sum(int(m.sum()) for _, m in seen)
    return nodes * (24 + (20 if ordered else 12)) + slots * 36, nodes, slots


def binary_bound(name, seen, pops, tests, n, t_far: bool, hits: int,
                 n_read: int | None = None):
    """(bound ms, bound_by) of a binary walk from its counted node visits
    (one slab test each) and triangle tests, against the bytes it must
    move: the table rows it read once, o and d (24 B) of each of the n_read
    rays that are walked (all n unless given: a lane at t_far = 0 needs
    only its t_far), t_far (4 B) per ray, and t, prim (8 B) per ray and one
    tri_id per hit for closest hit, one flag byte for any hit. `pops`,
    `tests` and `seen` are those of the walked rays."""
    n_read = n if n_read is None else n_read
    ops = int(pops.sum()) * OPS_SLAB + int(tests.sum()) * OPS_TRI
    io = n_read * 24 + n * (4 if t_far else 0)
    io += n * 8 + hits * 4 if name.endswith("closest") else n
    tables, nodes, slots = walked_table_bytes(seen, name.startswith("ordered"))
    nbytes = tables + io
    ops_ms, bytes_ms = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    per = max(n_read, 1)
    log(f"[bound] {name}: {int(pops.sum()) / per:.3f} node visits/ray, "
        f"{int(tests.sum()) / per:.3f} tri tests/ray"
        f"{'' if n_read == n else f' over {n_read} of {n} rays'}, {ops:.4g} FP32 ops -> "
        f"{ops_ms:.5f} ms; {nodes} distinct nodes and {slots} distinct slots read, {nbytes} "
        f"bytes -> {bytes_ms:.5f} ms")
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def short_shadow_rays(o, d, t, prim, scene):
    """Shadow rays towards the first light that stop short of it, t_far =
    0.999 of the distance, as the integrator's do. The binary and the wide
    walks test other boxes (exact against quantized, which are wider), so
    a hit within an ulp of t_far, as the light itself is at the full
    distance, may pass one walk's rounded slab test and not the other's;
    away from t_min and t_far their blocked flags agree exactly."""
    so, sd, tf = shadow_rays(o, d, t, prim, first_light_point(scene))
    return so, sd, tf * (1.0 - 1e-3)


def max_abs_err(out, ref) -> float:
    """max |kernel - plain| over t (closest hit) or the blocked flags as 0/1
    (any hit)."""
    if isinstance(out, tuple):
        return (out[0] - ref[0]).abs().max().item()
    return (out.int() - ref.int()).abs().max().item() * 1.0


def plain_walk_ms(fn) -> float:
    """Host milliseconds of one call of a plain walk, without its counts (a
    plain walk syncs with the host at every step)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def check_binary(kind, o, d, chunks, t_far, label):
    """One binary entry point against its plain version: t, prim and the
    blocked flags bit for bit. Returns (pops, tests, seen, output, max
    |error|)."""
    walk, variant = ((tp.skip_walk_plain, "skip") if kind.startswith("skip")
                     else (tp.ordered_walk_plain, "ordered"))
    if kind.endswith("closest"):
        out = tp.traverse_closest_packed(o, d, chunks, t_far=t_far, variant=variant)
    else:
        out = tp.traverse_anyhit_packed(o, d, chunks, t_far, variant=variant)
    seen = []
    ref = walk(o, d, chunks, t_far=t_far, any_hit=kind.endswith("anyhit"), counts=True,
               seen=seen)
    err = max_abs_err(out, ref[:2] if kind.endswith("closest") else ref[0])
    if kind.endswith("closest"):
        t, prim = out
        assert torch.equal(t, ref[0]) and torch.equal(prim, ref[1]), (kind, label)
        what = f"hit {float((prim >= 0).float().mean()):.4f}, t and prim identical"
    else:
        assert torch.equal(out, ref[0]), (kind, label, int((out != ref[0]).sum()))
        what = f"blocked {float(out.float().mean()):.4f}, identical"
    log(f"[binary] {kind} {label}: {o.shape[0]} rays over {len(chunks)} chunks, {what}, "
        f"max|d| {err:.3g}, {float(ref[-2].float().mean()):.2f} visits and "
        f"{float(ref[-1].float().mean()):.2f} tests a ray")
    return ref[-2], ref[-1], seen, out, err


def check_counts(kind, o, d, chunks, t_far, out, visits, tests, label, tag) -> float:
    """The counting build of entry point `kind` (skip_closest, ...) on rays
    (o, d, t_far): its output equal to the kernel's `out` and its node
    visits (the ordered walk's pops) and triangle tests equal to the plain
    walk's `visits` and `tests`, ray for ray; logs its warp turns and
    returns its SIMT efficiency."""
    got, v, t, turns, lanes = tp.walk_counts(kind, o, d, chunks, t_far)
    same_out = (torch.equal(got, out) if kind.endswith("anyhit")
                else all(map(torch.equal, got, out)))
    assert same_out and torch.equal(v, visits) and torch.equal(t, tests), (kind, label)
    nt, nl = int(turns.sum()), int(lanes.sum())
    simt = nl / max(32 * nt, 1)
    log(f"[{tag}] {label}: the counting build's visits and tests equal the plain walk's on "
        f"all {o.shape[0]} rays; {nt} warp turns, SIMT efficiency {simt:.4f}")
    return simt


def compare_with_wide(t, prim, t_w, prim_w, label) -> int:
    """A binary closest hit against the wide walk's: t within 1e-6, prim
    equal except where two triangles tie exactly in t. Returns the ties."""
    err = (t - t_w).abs().max().item()
    assert torch.allclose(t, t_w, rtol=TOL, atol=TOL), (label, err)
    bad = (prim != prim_w) & (t != t_w)
    ties = int(((prim != prim_w) & (t == t_w)).sum())
    assert not bad.any(), (label, int(bad.sum()))
    log(f"[{label}] against the wide walk: max|dt| {err:.3g}, prim ties {ties}")
    return ties


def binary_rays(scene, dev):
    """The binary walks' rays on Sponza: 65,536 primary rays (every 16th of
    the 1024x1024 frame) and 65,536 random rays inside the scene's box."""
    pid = render_api.tile_pixel_ids(HEIGHT, WIDTH, *render_api._tile_shape(HEIGHT, WIDTH),
                                    device=dev)[::16]
    o_cam, d_cam, _ = generate_rays(scene.camera, HEIGHT, WIDTH, sampler.seed_key(0, dev), 0,
                                    True, pixel_id=pid)
    rng = np.random.default_rng(2026)
    v = scene.triangles.verts.cpu().numpy()
    o_rnd = rng.uniform(v.min(0), v.max(0), (SUBSET, 3)).astype(np.float32)
    d_rnd = rng.standard_normal((SUBSET, 3)).astype(np.float32)
    d_rnd /= np.linalg.norm(d_rnd, axis=1, keepdims=True)
    o = torch.cat([o_cam, torch.from_numpy(o_rnd).to(dev)]).contiguous()
    d = torch.cat([d_cam, torch.from_numpy(d_rnd).to(dev)]).contiguous()
    return o, d


def phase_binary(scene, backend, dev, chunk_tris: int = tw.CHUNK_TRIS):
    """The packed traversal of Sponza 1M in 9 chunks of up to 120,000
    triangles: each entry point against its plain version; returns the
    ordered walks' rows."""
    t0 = time.perf_counter()
    chunks = [c.to(dev) for c in tp.build_chunked_packed(scene.triangles, chunk_tris=chunk_tris)]
    log(f"[binary] {len(chunks)} packed chunks, leaf 16, {sum(c.n_nodes for c in chunks)} "
        f"nodes, built in {time.perf_counter() - t0:.1f} s")
    assert len(chunks) == -(-scene.n_triangles // chunk_tris)
    assert all(c.leaf_size == 16 for c in chunks)
    o, d = binary_rays(scene, dev)

    # The packed traversal's path: each entry point once, through the
    # wrappers a caller uses, with the counts set to 0 just before.
    reset_launches()
    t, prim = tp.traverse_closest_packed(o, d, chunks)
    tp.traverse_closest_packed(o, d, chunks, variant="skip")
    so, sd, tf = short_shadow_rays(o, d, t, prim, scene)
    tf[::3] = 0.0
    tp.traverse_anyhit_packed(so, sd, chunks, tf)
    tp.traverse_anyhit_packed(so, sd, chunks, tf, variant="ordered")
    torch.cuda.synchronize()
    counts = launches()
    log(f"[binary] packed traversal launches {counts}")
    n = len(chunks)
    assert counts == only(skip_closest=n, skip_anyhit=n, ordered_closest=n,
                          ordered_anyhit=n), counts

    rows = []
    for kind, rays in (("ordered_closest", (o, d, None)), ("skip_closest", (o, d, None)),
                       ("ordered_anyhit", (so, sd, tf)), ("skip_anyhit", (so, sd, tf))):
        pops, tests, seen, out, err = check_binary(
            kind, *rays[:2], chunks, rays[2],
            "primary+random" if rays[2] is None else "shadow")
        if kind == "ordered_closest":
            t_w, prim_w = tw.traverse_closest_wide(o, d, backend.chunks)
            compare_with_wide(out[0], out[1], t_w, prim_w, "binary")
        if kind == "ordered_anyhit":
            b_w = tw.traverse_anyhit_wide(so, sd, backend.chunks, tf)
            assert torch.equal(out, b_w), int((out != b_w).sum())
        if not kind.startswith("ordered"):
            continue
        simt = check_counts(kind, *rays[:2], chunks, rays[2], out, pops, tests,
                            f"{kind} {'primary+random' if rays[2] is None else 'shadow'}",
                            "binary")
        call = ((lambda: tp.traverse_closest_packed(o, d, chunks)) if kind == "ordered_closest"
                else (lambda: tp.traverse_anyhit_packed(so, sd, chunks, tf, variant="ordered")))
        ms = events_ms(call, 5)
        plain_ms = plain_walk_ms(lambda: tp.ordered_walk_plain(
            *rays[:2], chunks, t_far=rays[2], any_hit=kind.endswith("anyhit")))
        hits = int((out[1] >= 0).sum()) if kind.endswith("closest") else 0
        bound, by = binary_bound(kind, seen, pops, tests, o.shape[0],
                                 rays[2] is not None, hits)
        log(f"[binary] {kind}: {ms:.4f} ms for {o.shape[0]} rays over {n} chunks, "
            f"{bound / ms:.4f} of the bound")
        rows.append({
            "name": kind, "route": "cuda", "source": BINARY_SOURCE,
            "replaces": BINARY_REPLACES[kind], "launches": counts[kind], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None, **binary_kernel_facts(kind), "simt": simt,
        })
    return rows


def phase_config2(dev, size: int | None = None, subdiv: int | None = None):
    """Config 2 through backend 'bvh', at its full size unless `size` and
    `subdiv` cut it. Returns the skip-link walks' rows and (scene, cfg,
    backend) for phase_dist."""
    cfg = get_config("bunny").override(backend="bvh", width=size, height=size,
                                       bunny_subdiv=subdiv)
    scene = build_scene(cfg).to(dev)
    t0 = time.perf_counter()
    backend = kapi.make_backend(cfg.backend, scene)
    (pk,) = backend.chunks
    log(f"[config2] bunny {scene.n_triangles} triangles, {scene.n_spheres} spheres, "
        f"{cfg.width}x{cfg.height} {cfg.spp} spp: flat BVH {pk.n_nodes} nodes, "
        f"{pk.tri.shape[0]} slots, built in {time.perf_counter() - t0:.2f} s")
    if subdiv is None:
        assert (scene.n_triangles, pk.n_nodes, pk.tri.shape[0]) == (81_924, 16_383, 131_072)
    reset_launches()
    with Recorder() as rec:
        img = render(scene, cfg, device=dev, backend=backend)
        torch.cuda.synchronize()
    counts = launches()
    log(f"[config2] launches {counts}")
    assert counts == only(skip_closest=cfg.spp, skip_anyhit=cfg.spp), counts
    img = img.cpu().numpy()
    assert img.shape == (cfg.height, cfg.width, 3) and np.isfinite(img).all() and (img >= 0).all()

    # The kernels on the frame's own rays, against the plain versions.
    stats = {"skip_closest": [], "skip_anyhit": []}
    errs = {"skip_closest": 0.0, "skip_anyhit": 0.0}
    for k, (o, d, variant, out) in enumerate(rec.calls["packed_closest"]):
        seen = []
        t_p, p_p, pops, tests = tp.skip_walk_plain(o, d, backend.chunks, counts=True, seen=seen)
        assert variant == "skip" and torch.equal(out[0], t_p) and torch.equal(out[1], p_p)
        errs["skip_closest"] = max(errs["skip_closest"], max_abs_err(out, (t_p, p_p)))
        stats["skip_closest"].append((pops, tests, seen, int((p_p >= 0).sum())))
        check_counts("skip_closest", o, d, backend.chunks, None, out, pops, tests,
                     f"skip_closest, primary rays of sample {k}", "config2")
    for k, (o, d, t_far, variant, out) in enumerate(rec.calls["packed_anyhit"]):
        seen = []
        b_p, pops, tests = tp.skip_walk_plain(o, d, backend.chunks, t_far=t_far,
                                              any_hit=True, counts=True, seen=seen)
        assert variant == "skip" and torch.equal(out, b_p)
        errs["skip_anyhit"] = max(errs["skip_anyhit"], max_abs_err(out, b_p))
        stats["skip_anyhit"].append((pops, tests, seen, 0))
        check_counts("skip_anyhit", o, d, backend.chunks, t_far, out, pops, tests,
                     f"skip_anyhit, shadow rays of sample {k}", "config2")
    log(f"[config2] {len(rec.calls['packed_closest'])} closest and "
        f"{len(rec.calls['packed_anyhit'])} any-hit calls identical to the plain versions")

    wide = kapi.make_backend("wide", scene)
    img_w = render(scene, cfg, device=dev, backend=wide).cpu().numpy()
    share = float(np.isclose(img, img_w, atol=1e-4).mean())
    log(f"[config2] image against the wide backend's: {share:.6f} of texels within 1e-4, "
        f"max |diff| {np.abs(img - img_w).max():.3g}, mean {img.mean():.5f}")
    assert share > 0.999, share
    (o, d, _, (t_b, p_b)), = rec.calls["packed_closest"][:1]
    t_w, p_w = tw.traverse_closest_wide(o, d, wide.chunks)
    compare_with_wide(t_b, p_b, t_w, p_w, "config2")

    gcfg = get_config("bunny").override(width=128, height=128, deterministic=True,
                                        bunny_subdiv=5, backend="bvh")
    gold = np.load(os.path.join(ROOT, "tests", "golden", "bunny128_sub5_det.npy"))
    g_img = render(build_scene(gcfg), gcfg, device=dev).cpu().numpy()
    g_share = float(np.isclose(g_img, gold, atol=1e-4).mean())
    log(f"[config2] bunny golden 128x128 det through bvh: {g_share:.6f} of texels within "
        f"1e-4, max |diff| {np.abs(g_img - gold).max():.3g}")
    assert g_share > 0.999, g_share

    render(scene, cfg, device=dev, backend=backend)
    frames = [events_ms(lambda: render(scene, cfg, device=dev, backend=backend), 1)
              for _ in range(5)]
    frame_ms = sum(frames) / len(frames)
    rays = cfg.width * cfg.height * cfg.spp
    log(f"[config2] frame ms {[round(f, 3) for f in frames]}: mean {frame_ms:.3f}, "
        f"min {min(frames):.3f}, max {max(frames):.3f}; {rays / frame_ms * 1e3:.4g} "
        f"primary rays/s")

    rows = []
    o, d, _, (t, prim) = rec.calls["packed_closest"][0]
    so, sd, stf, _, _ = rec.calls["packed_anyhit"][0]
    for kind, call in (
        ("skip_closest", lambda: tp.traverse_closest_packed(o, d, backend.chunks, variant="skip")),
        ("skip_anyhit", lambda: tp.traverse_anyhit_packed(so, sd, backend.chunks, stf)),
    ):
        ms = events_ms(call, 5)
        pops, tests, seen, hits = stats[kind][0]
        plain_ms = plain_walk_ms(
            (lambda: tp.skip_walk_plain(o, d, backend.chunks)) if kind == "skip_closest"
            else (lambda: tp.skip_walk_plain(so, sd, backend.chunks, t_far=stf, any_hit=True)))
        bound, by = binary_bound(kind, seen, pops, tests, o.shape[0],
                                 kind == "skip_anyhit", hits)
        log(f"[config2] {kind}: {ms:.4f} ms a launch on one sample's {o.shape[0]} rays, "
            f"plain {plain_ms:.1f} ms, {bound / ms:.4f} of the bound")
        rows.append({
            "name": kind, "route": "cuda", "source": BINARY_SOURCE,
            "replaces": BINARY_REPLACES[kind], "launches": counts[kind],
            "max_abs_err": errs[kind], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None, **binary_kernel_facts(kind),
        })
    return rows, (scene, cfg, backend)


def phase_shard(scene, backend, dev, size: int = WIDTH):
    """Scene sharding at world size 1 over a one-rank NCCL group (opened by
    main): the 1024x1024 frame's primary rays and their shadow rays, each
    kernel held bit for bit to its plain version on the padded chunks; and
    both ordered kernels there (the any hit on the shadow rays, beside the
    path), with the counting build ray for ray, their times, bounds and
    SIMT efficiency. Returns ({kernel: max |error|}, {ordered kind:
    {"launches", "ms", "bound_ms", "simt"}})."""
    from blink_torch.dist.scene_shard import (
        build_sharded_chunks,
        intersect_chunks_sharded,
        occluded_chunks_sharded,
    )

    t0 = time.perf_counter()
    chunks, meta = build_sharded_chunks(scene.triangles, 1, device=dev)
    log(f"[shard] build_sharded_chunks(tris, 1): {len(chunks)} chunks of {meta.n_nodes} "
        f"nodes, {meta.per_shard} on this rank, built in {time.perf_counter() - t0:.1f} s")
    n = -(-scene.n_triangles // tw.CHUNK_TRIS)
    assert len(chunks) == n and meta.per_shard == n
    o, d = primary_rays(scene, size, dev)
    reset_launches()
    t, prim = intersect_chunks_sharded(o, d, chunks, meta)
    so, sd, tf = short_shadow_rays(o, d, t, prim, scene)
    blocked = occluded_chunks_sharded(so, sd, chunks, meta, tf)
    torch.cuda.synchronize()
    counts = launches()
    log(f"[shard] launches {counts}")
    assert counts == only(ordered_closest=n, skip_anyhit=n), counts
    t0 = time.perf_counter()
    seen = []
    t_p, prim_p, pops, tests = tp.ordered_walk_plain(o, d, chunks, counts=True, seen=seen)
    b_p = tp.skip_walk_plain(so, sd, chunks, t_far=tf, any_hit=True)
    torch.cuda.synchronize()
    errs = {"ordered_closest": max_abs_err((t, prim), (t_p, prim_p)),
            "skip_anyhit": max_abs_err(blocked, b_p)}
    assert torch.equal(t, t_p) and torch.equal(prim, prim_p)
    assert torch.equal(blocked, b_p), int((blocked != b_p).sum())
    log(f"[shard] both kernels identical to their plain versions on the padded chunks "
        f"(plain walks {time.perf_counter() - t0:.1f} s): {json.dumps(errs)}")
    t_r, prim_r = tp.traverse_closest_packed(o, d, chunks)
    assert torch.equal(t, t_r) and torch.equal(prim, prim_r)
    t_w, prim_w = tw.traverse_closest_wide(o, d, backend.chunks)
    compare_with_wide(t, prim, t_w, prim_w, "shard")
    b_w = tw.traverse_anyhit_wide(so, sd, backend.chunks, tf)
    assert torch.equal(blocked, b_w), int((blocked != b_w).sum())
    log(f"[shard] {o.shape[0]} rays: hit {float((prim >= 0).float().mean()):.4f}, equal to "
        f"the replicated traversal; shadow blocked {float(blocked.float().mean()):.4f}, "
        f"equal to the wide any hit")
    ms = {
        "intersect_chunks_sharded": events_ms(
            lambda: intersect_chunks_sharded(o, d, chunks, meta), 3),
        "occluded_chunks_sharded": events_ms(
            lambda: occluded_chunks_sharded(so, sd, chunks, meta, tf), 3),
        "ordered_closest": events_ms(lambda: tp.traverse_closest_packed(o, d, chunks), 3),
        "skip_anyhit": events_ms(lambda: tp.traverse_anyhit_packed(so, sd, chunks, tf), 3),
        "wide_closest": events_ms(lambda: tw.traverse_closest_wide(o, d, backend.chunks), 3),
        "wide_anyhit": events_ms(lambda: tw.traverse_anyhit_wide(so, sd, backend.chunks, tf), 3),
    }
    log(f"[shard] ms at {o.shape[0]} rays over {n} chunks: " + json.dumps(ms))
    # Both ordered kernels at this size: the closest hit on the path's rays
    # (held above), the any hit on its shadow rays.
    b_o = tp.traverse_anyhit_packed(so, sd, chunks, tf, variant="ordered")
    seen_a = []
    b_op, pops_a, tests_a = tp.ordered_walk_plain(so, sd, chunks, t_far=tf, any_hit=True,
                                                  counts=True, seen=seen_a)
    assert torch.equal(b_o, b_op), int((b_o != b_op).sum())
    errs["ordered_anyhit"] = max_abs_err(b_o, b_op)
    ms["ordered_anyhit"] = events_ms(
        lambda: tp.traverse_anyhit_packed(so, sd, chunks, tf, variant="ordered"), 3)
    stats = {}
    for kind, rays, out, walked in (
            ("ordered_closest", (o, d, None), (t, prim), (seen, pops, tests)),
            ("ordered_anyhit", (so, sd, tf), b_o, (seen_a, pops_a, tests_a))):
        simt = check_counts(kind, *rays[:2], chunks, rays[2], out, *walked[1:],
                            f"{kind} at {o.shape[0]} rays", "shard")
        hits = int((prim >= 0).sum()) if kind == "ordered_closest" else 0
        bound, _ = binary_bound(kind, *walked, o.shape[0], rays[2] is not None, hits)
        log(f"[shard] {kind} at {o.shape[0]} rays: {ms[kind]:.4f} ms, "
            f"{bound / ms[kind]:.4f} of the bound, SIMT efficiency {simt:.4f}")
        stats[kind] = {"launches": counts[kind], "ms": ms[kind], "bound_ms": bound,
                       "simt": simt}
    return errs, stats


def path_walks(rec, chunks, depth: int) -> dict:
    """The skip-link walks of a recorded path frame through bvh: every call
    held bit for bit to skip_walk_plain on all its rays; the counting build
    held to the plain walk's visits and tests on sample 0's call of each
    bounce; each call's time (the wrapper re-run on the call's inputs, CUDA
    events, 3 calls) and bound. The bound counts live lanes (t_far > 0; a
    closest-hit call through bvh takes no t_far, so all its lanes are live)
    as phase_config4's does: their visits, tests and o and d, and t_far and
    the output of every lane; the rows read are the full call's, since a
    dead lane reads only the root, which every live lane reads too.
    Returns {kind: {"launches", "err", "ms", "bound_ms"}} over the calls."""
    out = {k: {"launches": 0, "err": 0.0, "ms": 0.0, "bound_ms": 0.0} for k in
           ("skip_closest", "skip_anyhit")}
    calls = {"skip_closest": [(o, d, None, res) for o, d, _, res in rec.calls["packed_closest"]],
             "skip_anyhit": [(o, d, tf, res) for o, d, tf, _, res in rec.calls["packed_anyhit"]]}
    for kind, recorded in calls.items():
        any_hit = kind == "skip_anyhit"
        for k, (o, d, tf, res) in enumerate(recorded):
            sample, bounce = divmod(k, depth)
            seen = []
            ref = tp.skip_walk_plain(o, d, chunks, t_far=tf, any_hit=any_hit, counts=True,
                                     seen=seen)
            pops, tests = ref[-2], ref[-1]
            same = torch.equal(res, ref[0]) if any_hit else all(map(torch.equal, res, ref[:2]))
            err = max_abs_err(res, ref[0] if any_hit else ref[:2])
            assert same, (kind, sample, bounce, err)
            if sample == 0:
                check_counts(kind, o, d, chunks, tf, res, pops, tests,
                             f"{kind}, bounce {bounce}", "dist")
            live = torch.ones_like(pops, dtype=torch.bool) if tf is None else tf > 0
            n, n_live = o.shape[0], int(live.sum())
            hits = 0 if any_hit else int((ref[1] >= 0).sum())
            bound, by = binary_bound(kind, seen, pops[live], tests[live], n, tf is not None,
                                     hits, n_read=n_live)
            ms = events_ms(lambda: (tp.traverse_anyhit_packed(o, d, chunks, tf) if any_hit
                                    else tp.traverse_closest_packed(o, d, chunks,
                                                                    variant="skip")), 3)
            what = (f"blocked {float(res.float().mean()):.4f}" if any_hit
                    else f"hit {float((res[1] >= 0).float().mean()):.4f}")
            log(f"[dist] sample {sample} bounce {bounce} {kind}: {n} rays, live "
                f"{n_live / n:.4f}, {what}, identical to the plain walk; "
                f"{float(pops[live].sum()) / max(n_live, 1):.3f} visits and "
                f"{float(tests[live].sum()) / max(n_live, 1):.3f} tests a live ray, "
                f"{ms:.4f} ms, bound {bound:.5f} ms ({by}), {bound / ms:.4f} of it")
            o_ = out[kind]
            o_["launches"] += len(chunks)
            o_["err"] = max(o_["err"], err)
            o_["ms"] += ms
            o_["bound_ms"] += bound
    return out


def phase_dist(scene, cfg, backend, dev) -> dict:
    """dist_render and dist_render_grad on config 2 through bvh, on the
    one-rank group, against render and render_grad; and dist_render against
    render with the path integrator at depth 4 (the skip-link walks on
    bounce rays), whose 16 + 16 walk calls path_walks holds and times.
    Returns path_walks's result."""
    from blink_torch.dist.render import dist_render, dist_render_grad

    img = render(scene, cfg, device=dev, backend=backend)
    img_d = dist_render(scene, cfg, backend=backend, device=dev)
    log(f"[dist] dist_render {tuple(img_d.shape)}: identical to render "
        f"{torch.equal(img_d, img)}")
    assert torch.equal(img_d, img)
    pcfg = cfg.override(integrator="path", max_depth=4)
    reset_launches()
    with Recorder() as rec:
        img_p = render(scene, pcfg, device=dev, backend=backend)
        torch.cuda.synchronize()
    counts = launches()
    img_pd = dist_render(scene, pcfg, backend=backend, device=dev)
    log(f"[dist] path depth 4 through bvh: launches {counts}; dist_render identical to "
        f"render {torch.equal(img_pd, img_p)}, image mean {img_p.mean().item():.6f} (direct "
        f"{img.mean().item():.6f})")
    walks = pcfg.spp * pcfg.max_depth * len(backend.chunks)
    assert counts == only(skip_closest=walks, skip_anyhit=walks), counts
    assert torch.equal(img_pd, img_p) and torch.isfinite(img_p).all()
    path = path_walks(rec, backend.chunks, pcfg.max_depth)
    log(f"[dist] path walks: " + json.dumps(path))
    names = ("albedo", "emission")
    target = torch.zeros_like(img)
    loss, g = render_grad(scene, cfg, target, names, device=dev, backend=backend)
    loss_d, g_d = dist_render_grad(scene, cfg, target, names, backend=backend, device=dev)
    log(f"[dist] loss render_grad {loss.item():.8g}, dist_render_grad {loss_d.item():.8g}")
    assert abs(loss.item() - loss_d.item()) <= 1e-5 * abs(loss.item())
    for n in names:
        scale = g[n].abs().max().item()
        log(f"[dist] grad {n}: max|diff| {(g_d[n] - g[n]).abs().max().item():.3g}, "
            f"max|g| {scale:.3g}")
        assert torch.isfinite(g_d[n]).all() and scale > 0, n
        assert torch.allclose(g_d[n], g[n], rtol=GRAD_RTOL, atol=GRAD_ATOL_SHARE * scale), n
    return path


# ------------------------------------------- soft gradients and the BVH variants


def oracle_image(size: int) -> np.ndarray:
    """The numpy oracle's Cornell (the fit preset's scene) at size x size,
    deterministic; main computes it in a process of its own beside the
    phases before [soft]."""
    from blink_torch.ref import ref_render
    from blink_torch.scene.builders import cornell_box

    return ref_render(cornell_box(), size, size)


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def soft_launches(scene, n_chunks: int, mesh: bool) -> dict:
    """The launches of one deterministic render through li_direct_soft
    (diff/soft.py), L lights and C chunks: its li_direct is a closest hit
    (C walks, a sphere_merge with spheres) and a shadow test a light (C
    walks, a sphere_pass with spheres); with spheres, the background's
    li_direct on the scene without spheres (no sphere launch) and the
    sphere-soft shading's shadow tests; with `mesh`, one more closest hit
    (backend.intersect) and the shadow tests of 5 candidate layers."""
    n_l, sph = scene.n_lights, scene.n_spheres > 0
    full = n_l * (1 + sph + 5 * mesh)  # shadow tests on the whole scene
    counts = {"wide_closest": (1 + sph + mesh) * n_chunks,
              "wide_anyhit": (full + n_l * sph) * n_chunks}
    if sph:
        counts.update(sphere_merge=1 + mesh, sphere_pass=full)
    return counts


def hold_recorded(rec, chunks, tag: str) -> None:
    """Every recorded wide-walk and sphere call held bit for bit to its
    plain version on its own inputs."""
    for o, d, t_far, (t, prim) in rec.calls["wide_closest"]:
        t_p, p_p = tw.closest_wide_plain(o, d, chunks, t_far)
        assert torch.equal(t, t_p) and torch.equal(prim, p_p), tag
    for o, d, t_far, blocked in rec.calls["wide_anyhit"]:
        assert torch.equal(blocked, tw.anyhit_wide_plain(o, d, chunks, t_far)), tag
    for name, plain in (("sphere_pass", ks.sphere_pass_plain),
                        ("sphere_merge", ks.sphere_merge_plain)):
        for o, d, c, r, t_min, t_in, out in rec.calls[name]:
            ref = plain(o, d, c, r, t_min, *(t_in if name == "sphere_merge" else (t_in,)))
            assert all(torch.equal(x, y) for x, y in zip(out, ref)), (tag, name)
    log(f"[{tag}] " + ", ".join(f"{len(v)} {k}" for k, v in rec.calls.items() if v)
        + " calls (of " + ", ".join(f"{v[0][0].shape[0]}" for v in rec.calls.values() if v)
        + " rays) identical to the plain versions")


def position_fit(scene, cfg, backend, dev, steps: int):
    """tests/test_fit.py's position recovery through `cfg`: centres off by
    0.08 x normal noise (a torch.Generator seeded 11), `steps` Adam steps at
    lr 1e-2 on sphere_center. Returns (loss ratio, centre error ratio)."""
    target = render(scene, cfg.override(soft_sigma=0.0), device=dev, backend=backend)
    noise = 0.08 * torch.randn(scene.spheres.center.shape,
                               generator=torch.Generator().manual_seed(11))
    scene0 = scene.replace(spheres=scene.spheres.replace(
        center=scene.spheres.center + noise.to(dev)))
    fitted, hist = fit(scene0, target, cfg,
                       FitConfig(steps=steps, lr=1e-2, optimize=("sphere_center",),
                                 log_path=os.devnull), device=dev, backend=backend)
    err0 = float(noise.abs().mean())
    err1 = float((fitted.spheres.center - scene.spheres.center).abs().mean())
    return hist[-1] / hist[0], err1 / err0


def phase_soft(dev, oracle, size: int = 256, fit_size: int = 48, steps: int = 120) -> dict:
    """Config 3 with soft_sigma 0.15 (Cornell through backend 'pallas',
    deterministic): one soft render's launches (soft_launches) and its
    image equal to the hard one and to the numpy oracle (`oracle`, a
    future of oracle_image(size)) by the goldens' rule, every recorded
    call bit for bit; the soft sphere_center gradient on the card against
    the CPU's; soft and hard fwd+bwd times; the position fit at fit_size
    to blink's bounds and at `size` (both ratios must fall)."""
    cfg = get_config("fit").override(backend="pallas", width=size, height=size,
                                     deterministic=True)
    cfg_soft = cfg.override(soft_sigma=0.15)
    scene = build_scene(cfg).to(dev)
    backend = kapi.make_backend(cfg.backend, scene)
    target = render(scene, cfg, device=dev, backend=backend)
    reset_launches()
    with Recorder() as rec:
        img = render(scene, cfg_soft, device=dev, backend=backend)
        torch.cuda.synchronize()
    counts = launches()
    want = only(**soft_launches(scene, len(backend.chunks), mesh=False))
    log(f"[soft] {size}x{size} soft_sigma 0.15: launches {nonzero(counts)} ({scene.n_lights} lights, "
        f"{len(backend.chunks)} chunk)")
    assert counts == want, (counts, want)
    assert torch.equal(img, target)
    hold_recorded(rec, backend.chunks, "soft")
    ref = oracle.result()
    img = img.cpu().numpy()
    share = float(np.isclose(img, ref, atol=1e-4).mean())
    mean_err = float(np.abs(img - ref).mean())
    log(f"[soft] image equal to the hard one; against the numpy oracle: {share:.6f} of texels "
        f"within 1e-4, mean |diff| {mean_err:.3g}")
    assert share > 0.999 and mean_err < 1e-4, (share, mean_err)

    names = ("sphere_center",)
    noise = 0.08 * torch.randn(scene.spheres.center.shape,
                               generator=torch.Generator().manual_seed(11))
    scene0 = scene.replace(spheres=scene.spheres.replace(
        center=scene.spheres.center + noise.to(dev)))
    _, g = render_grad(scene0, cfg_soft, target, names, device=dev, backend=backend)
    _, g_h = render_grad(scene0, cfg, target, names, device=dev, backend=backend)
    _, g_c = render_grad(scene0.to("cpu"), cfg_soft, target.cpu(), names, device="cpu")
    a, b, h = g["sphere_center"].cpu(), g_c["sphere_center"], g_h["sphere_center"].cpu()
    scale = b.abs().max().item()
    log(f"[soft] grad sphere_center: card vs CPU max|diff| {(a - b).abs().max().item():.3g}, "
        f"max|g| {scale:.3g}; soft vs hard max|diff| {(a - h).abs().max().item():.3g}")
    assert torch.isfinite(a).all() and scale > 0
    assert torch.allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL_SHARE * scale)

    t_s, t_h = timed_in_turns([
        lambda: render_grad(scene0, cfg_soft, target, names, device=dev, backend=backend),
        lambda: render_grad(scene0, cfg, target, names, device=dev, backend=backend)])
    ms_s, ms_h = sum(t_s) / len(t_s), sum(t_h) / len(t_h)
    log(f"[soft] fwd+bwd of sphere_center at {size}x{size}: soft {[round(x, 3) for x in t_s]} "
        f"mean {ms_s:.3f} ms, hard {[round(x, 3) for x in t_h]} mean {ms_h:.3f} ms, "
        f"soft/hard {ms_s / ms_h:.3f}")

    ratios = {}
    for s in (fit_size, size):
        c = cfg_soft.override(width=s, height=s)
        t0 = time.perf_counter()
        ratios[s] = position_fit(scene, c, backend, dev, steps)
        log(f"[soft] position fit {s}x{s}, {steps} steps: loss {ratios[s][0]:.4f}x, centre "
            f"error {ratios[s][1]:.4f}x of the start, {time.perf_counter() - t0:.1f} s")
    assert ratios[fit_size][0] < 0.45 and ratios[fit_size][1] < 0.6, ratios
    assert ratios[size][0] < 1.0 and ratios[size][1] < 1.0, ratios
    return {"soft_ms": ms_s, "hard_ms": ms_h, "ratios": ratios, "launches": counts}


def mesh_offset_fit(dev, size: int = 48, steps: int = 50):
    """tests/test_fit.py's mesh-offset recovery on bunny_scene(2) through
    backend 'pallas': a rigid offset of the icosphere's vertices, 50 Adam
    steps at lr 8e-3 on mesh-soft gradients; the backend is built anew from
    each step's vertices (the brute backend of the test reads them live).
    Returns (offset norm ratio, loss ratio)."""
    from blink_torch.api import merge_params
    from blink_torch.render.api import render_image
    from blink_torch.scene.builders import bunny_scene

    scene = bunny_scene(2).to(dev)
    cfg = get_config("bunny").override(width=size, height=size, spp=1, deterministic=True,
                                       backend="pallas")
    cfg_soft = cfg.override(soft_sigma=1.0, soft_mesh=True)
    with torch.no_grad():
        target = render_image(scene, cfg, kapi.make_backend("pallas", scene))
    p0 = scene.triangles.verts
    rows = torch.zeros((p0.shape[0], 1), device=dev)
    rows[8:] = 1.0  # the icosphere's rows
    p = torch.tensor([0.05, -0.03, 0.0], device=dev, requires_grad=True)
    err0 = torch.linalg.vector_norm(p).item()
    opt = torch.optim.Adam([p], lr=8e-3)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        s = merge_params(scene, {"tri_verts": p0 + rows * p[None, :]})
        backend = kapi.make_backend("pallas", s.replace(triangles=s.triangles.replace(
            verts=s.triangles.verts.detach())))
        loss = torch.mean((render_image(s, cfg_soft, backend) - target) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return torch.linalg.vector_norm(p).item() / err0, losses[-1] / losses[0]


def phase_softmesh(dev, size: int = 512, fit_size: int = 48) -> dict:
    """Config 2's bunny (81,924 triangles) at size x size, 1 spp,
    deterministic, soft_sigma 1.0 with soft_mesh, through 'pallas': the
    launches, every closest hit's rays in row-major pixel order, the image
    equal to the hard one, every recorded walk bit for bit; a finite,
    non-zero tri_verts gradient; soft and hard fwd+bwd times; the
    mesh-offset recovery at fit_size to blink's bounds."""
    cfg = get_config("bunny").override(width=size, height=size, spp=1, deterministic=True,
                                       backend="pallas")
    cfg_soft = cfg.override(soft_sigma=1.0, soft_mesh=True)
    scene = build_scene(cfg).to(dev)
    assert scene.n_triangles == 81_924, scene.n_triangles
    backend = kapi.make_backend(cfg.backend, scene)
    img_h = render(scene, cfg, device=dev, backend=backend)
    reset_launches()
    with Recorder() as rec:
        img = render(scene, cfg_soft, device=dev, backend=backend)
        torch.cuda.synchronize()
    counts = launches()
    want = only(**soft_launches(scene, len(backend.chunks), mesh=True))
    log(f"[softmesh] bunny {scene.n_triangles} triangles {size}x{size} soft_sigma 1.0 "
        f"soft_mesh: launches {nonzero(counts)} ({scene.n_lights} lights, {len(backend.chunks)} chunk)")
    assert counts == want, (counts, want)
    assert torch.equal(img, img_h)
    _, d_rm, _ = generate_rays(scene.camera, size, size, sampler.seed_key(cfg.seed, dev), 0,
                               False)
    assert all(torch.equal(d, d_rm) for _, d, _, _ in rec.calls["wide_closest"])
    log(f"[softmesh] image equal to the hard one; the {len(rec.calls['wide_closest'])} closest "
        f"hits' rays in row-major pixel order")
    hold_recorded(rec, backend.chunks, "softmesh")

    target = torch.zeros_like(img_h)
    names = ("tri_verts",)
    _, g = render_grad(scene, cfg_soft, target, names, device=dev, backend=backend)
    _, g_h = render_grad(scene, cfg, target, names, device=dev, backend=backend)
    gv, hv = g["tri_verts"], g_h["tri_verts"]
    moved = int((gv.abs().sum(1) > 0).sum())
    log(f"[softmesh] grad tri_verts: max|g| {gv.abs().max().item():.3g}, {moved} of "
        f"{gv.shape[0]} vertices non-zero, soft vs hard max|diff| "
        f"{(gv - hv).abs().max().item():.3g}")
    assert torch.isfinite(gv).all() and moved > 0
    t_s, t_h = timed_in_turns([
        lambda: render_grad(scene, cfg_soft, target, names, device=dev, backend=backend),
        lambda: render_grad(scene, cfg, target, names, device=dev, backend=backend)], reps=3)
    ms_s, ms_h = sum(t_s) / len(t_s), sum(t_h) / len(t_h)
    log(f"[softmesh] fwd+bwd of tri_verts at {size}x{size}: soft {[round(x, 3) for x in t_s]} "
        f"mean {ms_s:.3f} ms, hard {[round(x, 3) for x in t_h]} mean {ms_h:.3f} ms, "
        f"soft/hard {ms_s / ms_h:.3f}")
    t0 = time.perf_counter()
    off, loss = mesh_offset_fit(dev, fit_size)
    log(f"[softmesh] mesh-offset fit {fit_size}x{fit_size}, 50 steps: offset {off:.4f}x, "
        f"loss {loss:.4f}x of the start, {time.perf_counter() - t0:.1f} s")
    assert off < 0.5 and loss < 0.25, (off, loss)
    return {"soft_ms": ms_s, "hard_ms": ms_h, "offset": off, "loss": loss, "launches": counts}


def phase_bvhvariants(dev, n_tris: int = 200_000, size: int = 512, probe_rays: int = 65_536,
                      probe_reps: int = 1) -> dict:
    """The instanced hall (sponza_scene_instanced) at the probe's size: SBVH
    chunks (build_chunked_wide(spatial=True), the production constants)
    through the wide kernels on size x size primary rays and their shadow
    rays, bit for bit to the plain walks, and against the object-split
    chunks (t equal, prim equal but for counted exact-t ties); then the
    TLAS probe's run on the card, its two-level hits against the flat
    walk's (hits equal, t within 1e-5)."""
    from blink_torch.benchmarks import tlas_probe
    from blink_torch.scene.builders import sponza_scene_instanced

    _, insts, _, scene = sponza_scene_instanced(n_tris)
    scene = scene.to(dev)
    cam = scene.camera.origin.cpu().numpy().astype(np.float32)
    t0 = time.perf_counter()
    host = tw.build_chunked_wide(scene.triangles, chunk_tris=340_000, wide_leaf=44, quant=True,
                                 row_tables=False, order_from=cam, spatial=True)
    t1 = time.perf_counter()
    backend = kapi.make_backend("pallas", scene)
    t2 = time.perf_counter()
    sbvh_s = t1 - t0
    spatial = [tw.WideChunk.from_host(c, dev) for c in host]
    refs = sum(int((c.tri_id >= 0).sum()) for c in host)
    log(f"[bvhvariants] instanced hall {scene.n_triangles} triangles, {len(insts)} instances: "
        f"SBVH chunks built in {sbvh_s:.2f} s ({len(spatial)} chunk, {refs} references, "
        f"{spatial[0].n_wide} wide nodes), object-split chunks in {t2 - t1:.2f} s "
        f"({backend.chunks[0].n_wide} wide nodes)")

    o, d = primary_rays(scene, size, dev)
    n_s, n_o = len(spatial), len(backend.chunks)
    reset_launches()
    t_s, p_s = tw.traverse_closest_wide(o, d, spatial)
    so, sd, tf = short_shadow_rays(o, d, t_s, p_s, scene)
    b_s = tw.traverse_anyhit_wide(so, sd, spatial, tf)
    t_o, p_o = tw.traverse_closest_wide(o, d, backend.chunks)
    b_o = tw.traverse_anyhit_wide(so, sd, backend.chunks, tf)
    torch.cuda.synchronize()
    counts = launches()
    log(f"[bvhvariants] launches {nonzero(counts)}")
    assert counts == only(wide_closest=n_s + n_o, wide_anyhit=n_s + n_o), counts
    t_p, p_p = tw.closest_wide_plain(o, d, spatial)
    assert torch.equal(t_s, t_p) and torch.equal(p_s, p_p)
    assert torch.equal(b_s, tw.anyhit_wide_plain(so, sd, spatial, tf))
    ties = int((p_s != p_o).sum())
    log(f"[bvhvariants] SBVH walks on {o.shape[0]} primary rays (hit "
        f"{float((p_s >= 0).float().mean()):.4f}) and their shadow rays (blocked "
        f"{float(b_s.float().mean()):.4f}) identical to the plain walks; against the "
        f"object-split chunks: t identical {torch.equal(t_s, t_o)}, prim ties {ties}, blocked "
        f"flags differing {int((b_s != b_o).sum())}")
    assert torch.equal(t_s, t_o)
    assert torch.equal(b_s, b_o)
    times = timed_in_turns([lambda: tw.traverse_closest_wide(o, d, spatial),
                            lambda: tw.traverse_closest_wide(o, d, backend.chunks),
                            lambda: tw.traverse_anyhit_wide(so, sd, spatial, tf),
                            lambda: tw.traverse_anyhit_wide(so, sd, backend.chunks, tf)])
    ms = [sum(t) / len(t) for t in times]
    log(f"[bvhvariants] ms a call (closest SBVH, closest object, any hit SBVH, any hit "
        f"object): {[round(x, 4) for x in ms]}")

    reset_launches()
    t0 = time.perf_counter()
    out, (t_fl, p_fl), (t_tl, p_tl) = tlas_probe.run(n_tris, probe_rays, probe_reps, dev)
    torch.cuda.synchronize()
    counts = launches()
    log(f"[bvhvariants] probe {time.perf_counter() - t0:.1f} s, launches {nonzero(counts)}")
    assert counts == only(wide_closest=(1 + probe_reps) * out["flat"]["n_chunks"]), counts
    hit = p_fl >= 0
    assert torch.equal(hit, p_tl >= 0)
    assert torch.allclose(t_tl[hit], t_fl[hit], rtol=1e-5, atol=1e-5)
    assert out["parity_exact_hits"]
    log("[bvhvariants] probe " + json.dumps(out))
    return {"sbvh_build_s": sbvh_s, "ms": ms, "probe": out}


def timed_phase(tag: str, fn, *args, **kw):
    """fn(*args, **kw), its seconds logged under [tag]."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    log(f"[{tag}] phase {time.perf_counter() - t0:.1f} s")
    return out


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

    # The numpy oracle of [soft] renders in a process of its own meanwhile.
    oracle_pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    try:
        oracle = oracle_pool.submit(oracle_image, 256)
        timed_phase("build", phase_build)
        sphere_err, big = timed_phase("sphere", phase_sphere_parity, dev)
        timed_phase("cornell", phase_cornell, dev)
        sphere_rows = timed_phase("config3", phase_config3, dev, big)
        del big
        timed_phase("soft", phase_soft, dev, oracle)
    finally:
        oracle_pool.shutdown(cancel_futures=True)
    timed_phase("softmesh", phase_softmesh, dev)
    for row in sphere_rows:
        row["max_abs_err"] = max(row["max_abs_err"], sphere_err)

    cfg = get_config("sponza").override(width=WIDTH, height=HEIGHT, spp=1,
                                        integrator="direct")
    t0 = time.perf_counter()
    scene = build_scene(cfg).to(dev)
    t1 = time.perf_counter()
    backend = kapi.make_backend(cfg.backend, scene)
    t2 = time.perf_counter()
    log(f"[scene] sponza {scene.n_triangles} triangles, {scene.n_lights} lights, "
        f"{scene.n_spheres} spheres: scene {t1 - t0:.1f} s, BVH {t2 - t1:.1f} s, "
        f"{len(backend.chunks)} chunks, max_stack {backend.chunks[0].max_stack}")

    errs = timed_phase("parity", phase_parity, scene, backend, dev)
    timed_phase("golden", phase_golden, dev)
    rows, frame_ms = timed_phase("frame", phase_frame, scene, backend, cfg, dev, errs)
    profile(lambda: render(scene, cfg, device=dev, backend=backend), "frame", frame_ms)
    fwd_bwd = timed_phase("fwd+bwd", phase_fwd_bwd, scene, backend, dev)
    bench = timed_phase("bench", phase_bench, scene, backend, dev)
    config4, config4_ms = timed_phase("config4", phase_config4, scene, backend, dev)
    fb, c4 = bench["detail"]["fwd_bwd"], bench["detail"]["config4"]
    log(f"[bench] the harness against this script's own times (ms): fwd+bwd geometry "
        f"{fb['wall_s'] * 1e3:.3f} against {fwd_bwd['geometry_ms']:.3f}, materials "
        f"{fb['materials_only']['wall_s'] * 1e3:.3f} against {fwd_bwd['materials_ms']:.3f}, "
        f"forward {fb['fwd_only_wall_s'] * 1e3:.3f} against {fwd_bwd['fwd_ms']:.3f}; "
        f"config 4 {c4['wall_s'] * 1e3:.3f} against {config4_ms:.3f}")
    for row in rows:
        c4 = config4[row["name"]]
        row["max_abs_err"] = max(row["max_abs_err"], c4["err"])
        row.update(config4_launches=c4["launches"], config4_ms=c4["ms"],
                   config4_bound_ms=c4["bound_ms"])
    timed_phase("config5", phase_config5, scene, backend, dev)
    rows += sphere_rows
    leafmode_rows = timed_phase("leafmode", phase_leafmode, scene, backend, cfg, dev)

    binary_rows = timed_phase("binary", phase_binary, scene, backend, dev)
    skip_rows, config2 = timed_phase("config2", phase_config2, dev)
    timed_phase("bvhvariants", phase_bvhvariants, dev)
    rows += skip_rows + binary_rows + leafmode_rows
    from blink_torch.dist import mesh

    torch.cuda.set_device(dev)
    mesh.init_single_rank("nccl")
    try:
        shard_errs, shard = timed_phase("shard", phase_shard, scene, backend, dev)
        path = timed_phase("dist", phase_dist, *config2, dev)
    finally:
        mesh.close()

    for row in rows:
        row["max_abs_err"] = max(row["max_abs_err"], shard_errs.get(row["name"], 0.0))
        if row["name"] in shard:
            row.update({f"shard_{k}": v for k, v in shard[row["name"]].items()})
        if row["name"] in path:
            p = path[row["name"]]
            row["max_abs_err"] = max(row["max_abs_err"], p["err"])
            row.update(path_launches=p["launches"], path_ms=p["ms"], path_bound_ms=p["bound_ms"])
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
