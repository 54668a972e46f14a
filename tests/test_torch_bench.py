"""blink_torch's bench harness and headline against blink's, on the CPU.

- bench_primary_traversal on a 3,000-triangle Sponza at 16x16 returns
  blink's keys, and its hit fraction equals blink's bench_primary_traversal
  on the same scene to within one ray (blink times its flat BVH on the CPU,
  the port the same production wide backend it walks on the card). Both
  harnesses' timers make one call here: the loops time nothing on the CPU.
- bench_render and bench_render_grad return blink's keys on Cornell 16x16,
  with rays = w*h*spp.
- roofline's arithmetic against hand-computed values at the H100's rates;
  it takes no default pops or tests. run_bench counts them on its own
  config's primary rays, and skips the roofline on a backend with no wide
  walk.
- The grad_allclose probe passes, and its three largest albedo gradients
  are jax.grad's of blink's same loss, at the same indices.
- bench_scaling at world size 1 returns one point, without a speedup.
- The bench CLI prints run_bench's dict as one JSON line.
- The headline raises without a CUDA device: no CPU fallback.
- refit_bvh on moved vertices (3,000 triangles) equals blink's refit_bvh
  exactly, and tests/test_bvh.py::test_refit_tracks_moved_vertices's checks hold.
"""
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blink.api import build_scene as jax_build_scene
from blink.benchmarks import harness as jax_harness
from blink.bvh import build_flat_bvh as jax_build_flat_bvh
from blink.bvh import refit_bvh as jax_refit_bvh
from blink.config import get_config as jax_get_config
from blink.kernels.api import make_backend as jax_make_backend
from blink.render.api import render_image as jax_render_image
from blink.scene import builders as jax_builders
from blink_torch import cli
from blink_torch.api import build_scene
from blink_torch.benchmarks import harness, headline
from blink_torch.bvh.build import build_flat_bvh, refit_bvh
from blink_torch.bvh.sah import build_sah_bvh
from blink_torch.config import get_config
from blink_torch.kernels import traverse_packed as tp
from blink_torch.kernels import traverse_wide as tw
from blink_torch.kernels.api import make_backend
from blink_torch.kernels.bruteforce import intersect_brute
from blink_torch.scene import builders
from blink_torch.scene.scene import make_scene
from test_bvh import _random_rays, _random_tris
from test_torch_build import port_tris

PRIMARY_KEYS = {"wall_s", "rays", "rays_per_s", "latency_wall_s", "launch_overhead_s",
                "hit_fraction", "n_chunks"}


def _one_call(checksum):
    """A stand-in for a harness's _time and _time_sustained: the seconds
    of one call up to its checksum's read."""
    def timer(fn, *args, **kw):
        t0 = time.perf_counter()
        checksum(fn(*args))
        return time.perf_counter() - t0
    return timer


def test_primary_traversal_matches_reference(monkeypatch):
    size = 16
    for h in (harness, jax_harness):
        for name in ("_time", "_time_sustained"):
            monkeypatch.setattr(h, name, _one_call(h._host_checksum))
    out = harness.bench_primary_traversal(builders.sponza_scene(3000), size, device="cpu")
    ref = jax_harness.bench_primary_traversal(jax_builders.sponza_scene(3000), size)
    assert set(ref) == PRIMARY_KEYS <= set(out)
    assert out["rays"] == ref["rays"] == size * size and out["n_chunks"] == 1
    assert 0.3 < ref["hit_fraction"] < 1.0
    assert abs(out["hit_fraction"] - ref["hit_fraction"]) <= 1.0 / size ** 2
    assert out["wall_s"] > 0 and out["rays_per_s"] == size * size / out["wall_s"]
    assert out["pops_per_ray"] >= 1 and out["tests_per_ray"] > 0


def test_render_and_grad_keys():
    cfg = get_config("cornell").override(width=16, height=16, spp=2)
    scene = build_scene(cfg)
    fwd = harness.bench_render(scene, cfg, device="cpu")
    assert set(fwd) == {"wall_s", "rays", "rays_per_s", "traced_rays_per_s"}
    assert fwd["rays"] == 16 * 16 * 2 and fwd["traced_rays_per_s"] == fwd["rays_per_s"]
    grad = harness.bench_render_grad(scene, cfg, ("sphere_center", "albedo"), device="cpu")
    assert set(grad) == {"wall_s", "rays", "rays_per_s_fwd_bwd"}
    assert grad["rays"] == 16 * 16 * 2 and grad["rays_per_s_fwd_bwd"] > 0


def test_roofline_arithmetic():
    """10 pops and 20 tests a ray: 10 * 160 + 20 * 36 + 32 = 2352 bytes and
    10 * 160 + 20 * 35 = 2300 FP32 operations a ray."""
    r = harness.roofline(1000, 1e9, hbm_gbps_measured=3000.0, pops_per_ray=10,
                         tests_per_ray=20)
    assert r["hbm_gbps"] == 3350.0 and r["fp32_tflops"] == 67.0
    assert r["nominal_bytes_per_ray"] == 2352 and r["ops_per_ray"] == 2300
    assert r["implied_bytes_per_ray"] == pytest.approx(3350.0)
    assert r["sol_rays_per_s_at_nominal"] == pytest.approx(3.35e12 / 2352)
    assert r["sol_rays_per_s_at_measured_bw"] == pytest.approx(3.0e12 / 2352)
    assert r["sol_rays_per_s_fp32"] == pytest.approx(67e12 / 2300)
    assert r["fraction_of_sol"] == pytest.approx(1e9 * 2352 / 3.35e12)
    assert r["fraction_of_sol_measured_bw"] == pytest.approx(1e9 * 2352 / 3.0e12)
    assert r["fraction_of_sol_fp32"] == pytest.approx(1e9 * 2300 / 67e12)
    unmeasured = harness.roofline(1000, 1e9, pops_per_ray=10, tests_per_ray=20)
    assert unmeasured["hbm_gbps_measured"] is None
    assert unmeasured["sol_rays_per_s_at_measured_bw"] is None
    assert unmeasured["fraction_of_sol_measured_bw"] is None
    assert r["bytes_model"] == unmeasured["bytes_model"] == "no_reuse"
    with pytest.raises(TypeError, match="pops_per_ray"):
        harness.roofline(1000, 1e9)


def test_run_bench_counts_its_own_rays(monkeypatch):
    """run_bench's roofline takes the pops and tests of the closest-hit
    walk on the config's own primary rays; on brute, whose closest hit
    walks no tree, it says so instead."""
    def small(name):
        return get_config(name).override(width=16, height=8, spp=1)

    monkeypatch.setattr(harness, "get_config", small)
    out = harness.run_bench("cornell", quick=True, device="cpu", backend="pallas")
    assert out["backend"] == "wide" and {"forward", "fwd_bwd"} <= set(out)
    scene = build_scene(small("cornell"))
    o, d = harness.primary_rays(scene, 8, 16, torch.device("cpu"))
    _, _, pops, tests = tw.closest_wide_plain(o, d, make_backend("pallas", scene).chunks,
                                              counts=True)
    rl = out["roofline"]
    assert rl["pops_per_ray"] == float(pops.sum()) / 128 > 0
    assert rl["tests_per_ray"] == float(tests.sum()) / 128 > 0
    assert rl["fraction_of_sol"] == pytest.approx(
        out["forward"]["rays_per_s"] * rl["nominal_bytes_per_ray"] / 3.35e12)
    brute = harness.run_bench("cornell", quick=True, device="cpu")
    assert brute["backend"] == "brute" and "no wide walk" in brute["roofline"]["skipped"]


def test_grad_allclose_probe_matches_reference():
    from test_torch_grads import GRAD_TOL

    probe = headline._grad_allclose_probe("cpu")
    assert probe["pass"] and probe["worst_rel_err"] < 0.05 and probe["param"] == "albedo"
    cfg = jax_get_config("cornell").override(width=32, height=32, deterministic=True,
                                             backend="brute")
    scene = jax_build_scene(cfg)
    backend = jax_make_backend("brute", scene)

    def loss(v):
        s = scene.replace(materials=scene.materials.replace(albedo=v))
        return jnp.mean(jax_render_image(s, cfg, backend) ** 2)

    g = np.asarray(jax.jit(jax.grad(loss))(scene.materials.albedo)).ravel()
    top = np.argsort(-np.abs(g))[:3]
    assert sorted(probe["indices"]) == sorted(top.tolist())
    rtol, atol = GRAD_TOL["albedo"]
    np.testing.assert_allclose(probe["grads"], g[probe["indices"]], rtol=rtol, atol=atol)


def test_scaling_at_world_size_one():
    out = harness.bench_scaling(size=16, device="cpu")
    assert out["platform"] == "cpu" and out["world_size"] == 1 and "no speedup" in out["note"]
    (point,) = out["points"]
    assert point["devices"] == 1 and point["rays_per_device"] == 16 * 16
    assert point["rays_per_s"] > 0 and "speedup_vs_1" not in point


def test_bench_cli(monkeypatch, capsys):
    args = cli.build_parser().parse_args(["bench"])
    assert (args.config, args.quick, args.device, args.backend, args.fn) == (
        "sponza", False, None, None, cli.cmd_bench)
    calls = []

    def run_bench(config_name, quick=False, device=None, backend=None):
        calls.append((config_name, quick, device, backend))
        return {"config": config_name, "forward": {"rays_per_s": 1.5}}

    monkeypatch.setattr(harness, "run_bench", run_bench)
    assert cli.main(["bench", "--config", "cornell", "--quick", "--device", "cpu",
                     "--backend", "pallas"]) == 0
    assert calls == [("cornell", True, "cpu", "pallas")]
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["forward"]["rays_per_s"] == 1.5


def test_headline_needs_a_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device available"):
        headline.main(["--fast", "--tris", "64", "--size", "16"])
    with pytest.raises(RuntimeError, match="no CUDA device available"):
        harness.run_bench("cornell", quick=True)


def test_refit_matches_reference():
    # One size against blink: each tree depth is a compile of blink's refit
    # (about 3 s).
    shift = np.float32([10.0, -3.0, 0.5])
    tris = _random_tris(3000, 5)
    rng = np.random.default_rng(5)
    v = np.asarray(tris.verts)
    moved_v = (v + shift + rng.normal(0, 0.2, v.shape)).astype(np.float32)
    ref = jax_refit_bvh(jax_build_flat_bvh(tris), tris.replace(verts=jnp.asarray(moved_v)))
    pt = port_tris(tris)
    bvh = build_flat_bvh(pt.verts.numpy(), pt.idx.numpy())
    np.testing.assert_array_equal(bvh.heap2pre, np.asarray(ref.heap2pre))
    refit = refit_bvh(bvh, pt.replace(verts=torch.from_numpy(moved_v)))
    for f in ("lo", "hi", "tv0", "te1", "te2"):
        got = getattr(refit, f)
        assert got.dtype == torch.float32, f
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(ref, f)), err_msg=f)

    # tests/test_bvh.py::test_refit_tracks_moved_vertices on the port: a
    # global translation keeps the Morton order, so the refit equals a
    # fresh build; the walk over it equals brute force on the moved scene.
    pt = port_tris(_random_tris(64, 9))
    bvh = build_flat_bvh(pt.verts.numpy(), pt.idx.numpy())
    moved = pt.replace(verts=pt.verts + torch.from_numpy(shift))
    refit = refit_bvh(bvh, moved)
    rebuilt = build_flat_bvh(moved.verts.numpy(), moved.idx.numpy())
    np.testing.assert_allclose(refit.lo.numpy(), rebuilt.lo, atol=1e-4)
    np.testing.assert_allclose(refit.hi.numpy(), rebuilt.hi, atol=1e-4)
    np.testing.assert_allclose(refit.tv0.numpy(), rebuilt.tv0, atol=1e-5)
    o, d = (torch.from_numpy(np.array(a)) for a in _random_rays(256, 11))
    o = o + torch.from_numpy(shift)
    hb = intersect_brute(o, d, make_scene(triangles=moved))
    host = dataclasses.replace(refit, **{f: getattr(refit, f).numpy()
                                         for f in ("lo", "hi", "tv0", "te1", "te2")})
    t, _ = tp.traverse_closest_packed(o, d, [tp.pack_bvh_planes(host)], variant="skip")
    np.testing.assert_allclose(t.numpy(), hb.t.numpy(), rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="heap2pre"):  # an SAH tree has none
        refit_bvh(build_sah_bvh(pt.verts.numpy(), pt.idx.numpy(), 16), pt)
