"""blink_torch's path-tracing helpers against blink, on the CPU.

- The BRDF helpers (make_onb, from_local, sample_cosine, brdf_eval,
  brdf_pdf) on 4,096 seeded unit normals, some within 1e-6 of n.z = -1:
  rtol and atol 1e-6 (the two libms differ by up to 2.4e-7 in sqrt and
  6e-8 in sin and cos, so not bit for bit).
- compaction_order equal to blink's permutation, and blink's invariants;
  tile_pixel_ids_spp equal to blink's for sb 4, 16 and 64.
- Every backend gives dead lanes the canonical miss.
- The CLI renders the sponza preset (config 4) at toy size.
- The first multi-threaded CPU math call after importing blink_torch is
  exact, in 32 fresh processes.

Path images and gradients are test_torch_path_image.py's.
"""
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blink.core import vec as jax_vec
from blink.diff import brdf as jax_brdf
from blink.render import api as jax_render_api
from blink.render.wavefront import compaction_order as jax_compaction_order
from blink_torch.api import build_scene
from blink_torch.config import get_config
from blink_torch.core import vec
from blink_torch.diff import brdf
from blink_torch.kernels.api import make_backend
from blink_torch.render import api as render_api
from blink_torch.render.wavefront import compaction_order

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-6, atol=1e-6)


def _normals(n=4096, seed=0):
    """Seeded unit normals, the last 64 within 1e-6 of (0, 0, -1) in z."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    k = 64
    xy = rng.standard_normal((k, 2))
    xy *= np.sqrt(rng.uniform(0.0, 1.8e-6, k))[:, None] / np.linalg.norm(xy, axis=1,
                                                                          keepdims=True)
    v[-k:, :2] = xy
    v[-k:, 2] = -np.sqrt(1.0 - (xy ** 2).sum(1))
    v = v.astype(np.float32)
    assert (v[-k:, 2] + 1.0 < 1e-6).all()
    return v


def test_brdf_helpers_match_reference():
    rng = np.random.default_rng(1)
    n = _normals()
    u1, u2 = (rng.random(n.shape[0], dtype=np.float32) for _ in range(2))
    wo = _normals(seed=2)
    t_n, t_u1, t_u2, t_wo = (torch.from_numpy(a) for a in (n, u1, u2, wo))

    frame = vec.make_onb(t_n)
    jframe = jax_vec.make_onb(jnp.asarray(n))
    for got, want in zip(frame, jframe):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    loc = rng.standard_normal(n.shape).astype(np.float32)
    np.testing.assert_allclose(
        vec.from_local(torch.from_numpy(loc), *frame).numpy(),
        np.asarray(jax_vec.from_local(jnp.asarray(loc), *jframe)), **TOL)
    # The frame is orthonormal, near n.z = -1 too (checked in f64).
    t, b, nn = (x.numpy().astype(np.float64) for x in frame)
    for a, c in ((t, b), (t, nn), (b, nn)):
        assert np.abs((a * c).sum(1)).max() < 1e-5
    np.testing.assert_allclose(np.linalg.norm(t, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(b, axis=1), 1.0, atol=1e-5)

    wi = brdf.sample_cosine(t_n, t_u1, t_u2)
    wi_ref = np.asarray(jax_brdf.sample_cosine(jnp.asarray(n), jnp.asarray(u1), jnp.asarray(u2)))
    np.testing.assert_allclose(wi.numpy(), wi_ref, **TOL)
    assert (vec.vdot(wi, t_n) >= -1e-6).all()  # the upper hemisphere

    albedo = rng.random(n.shape, dtype=np.float32)
    np.testing.assert_allclose(
        brdf.brdf_eval(torch.from_numpy(albedo), t_wo, wi, t_n).numpy(),
        np.asarray(jax_brdf.brdf_eval(jnp.asarray(albedo), jnp.asarray(wo), jnp.asarray(wi_ref),
                                      jnp.asarray(n))), **TOL)
    np.testing.assert_allclose(
        brdf.brdf_pdf(wi, t_n).numpy(),
        np.asarray(jax_brdf.brdf_pdf(jnp.asarray(wi_ref), jnp.asarray(n))), **TOL)
    np.testing.assert_allclose(vec.luminance(t_n).numpy(),
                               np.asarray(jax_vec.luminance(jnp.asarray(n))), **TOL)
    np.testing.assert_allclose(
        vec.to_local(t_wo, *frame).numpy(),
        np.asarray(jax_vec.to_local(jnp.asarray(wo), *jframe)), **TOL)
    np.testing.assert_allclose(vec.reflect(t_wo, t_n).numpy(),
                               np.asarray(jax_vec.reflect(jnp.asarray(wo), jnp.asarray(n))), **TOL)


def test_compaction_order_matches_reference():
    rng = np.random.default_rng(0)
    n = 512
    alive = rng.random(n) >= 0.4
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    perm = compaction_order(torch.from_numpy(alive), torch.from_numpy(o),
                            torch.from_numpy(d)).numpy()
    ref = np.asarray(jax_compaction_order(jnp.asarray(alive), jnp.asarray(o), jnp.asarray(d)))
    np.testing.assert_array_equal(perm, ref)
    # blink's invariants (tests/test_wavefront.py).
    assert sorted(perm.tolist()) == list(range(n))
    a_sorted = alive[perm]
    first_dead = np.argmax(~a_sorted) if (~a_sorted).any() else n
    assert 0 < first_dead < n and not a_sorted[first_dead:].any()
    dn = d[perm][a_sorted]
    octant = (dn[:, 0] < 0) * 1 + (dn[:, 1] < 0) * 2 + (dn[:, 2] < 0) * 4
    assert (np.diff(octant) >= 0).all()


@pytest.mark.parametrize("sb", [4, 16, 64])
def test_tile_pixel_ids_spp_matches_reference(sb):
    pid, sidx = render_api.tile_pixel_ids_spp(64, 64, sb)
    ref_pid, ref_sidx = jax_render_api.tile_pixel_ids_spp(64, 64, sb)
    np.testing.assert_array_equal(pid.numpy(), np.asarray(ref_pid))
    np.testing.assert_array_equal(sidx.numpy(), np.asarray(ref_sidx))
    # Each (pixel, sample) pair once.
    assert torch.unique(pid * sb + sidx).numel() == 64 * 64 * sb


def test_intersect_alive_mask_canonical_miss():
    """Every backend gives dead lanes the canonical miss (kind 0, prim 0,
    t T_MAX) and leaves live lanes as the unmasked brute force has them."""
    from blink_torch.kernels.types import T_MAX

    cfg = get_config("cornell")
    scene = build_scene(cfg)
    rng = np.random.default_rng(7)
    n = 256
    o = torch.from_numpy(rng.normal(0, 0.5, (n, 3)).astype(np.float32))
    d0 = rng.normal(size=(n, 3))
    d = torch.from_numpy((d0 / np.linalg.norm(d0, axis=-1, keepdims=True)).astype(np.float32))
    alive = torch.from_numpy(rng.random(n) < 0.6)
    h_none = make_backend("brute", scene).intersect(o, d, scene)
    assert (h_none.kind[alive] != 0).any()
    for name in ("brute", "bvh", "wide"):
        h = make_backend(name, scene).intersect(o, d, scene, alive=alive)
        assert (h.kind[~alive] == 0).all() and (h.prim[~alive] == 0).all(), name
        assert (h.t[~alive] == T_MAX).all(), name
        assert torch.equal(h.kind[alive], h_none.kind[alive]), name
        assert torch.equal(h.prim[alive], h_none.prim[alive]), name
        np.testing.assert_allclose(h.t[alive].numpy(), h_none.t[alive].numpy(), rtol=1e-6,
                                   err_msg=name)


def test_cli_render_sponza_preset(tmp_path):
    """Config 4's preset through the CLI at toy size: 2,000 triangles,
    32x32, 16 spp, path depth 4."""
    out = tmp_path / "s.npy"
    # One intra-op thread, as in the test workers: torch's default of one a
    # core spins on cores the other workers use (a 32x32 path render: 16
    # CPU-seconds at 8 threads, 5 at one, the same wall time).
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "blink_torch", "render", "--config", "sponza",
         "--sponza-tris", "2000", "--width", "32", "--height", "32", "--spp", "16",
         "--max-depth", "4", "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert '"rays": 16384' in proc.stdout
    img = np.load(out)
    assert img.shape == (32, 32, 3) and np.isfinite(img).all() and img.max() > 0


def test_first_cpu_math_call_is_exact():
    """Without blink_torch's one-thread call at import, the first float cos
    that several intra-op threads enter at once can come out off by up to
    2^-12 on one thread's share, in some fresh processes (MKL setting up
    its vector math). 32 fresh processes, 8 at a time, each import
    blink_torch and take the cos of 65,536 floats once."""
    code = ("import numpy as np, torch, blink_torch\n"
            "x = np.random.default_rng(0).random(1 << 16, dtype=np.float32)\n"
            "y = torch.cos(torch.from_numpy(x)).numpy()\n"
            "print(int((np.abs(y - np.cos(x.astype(np.float64))) > 1e-6).sum()))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    bad = []
    for _ in range(4):
        procs = [subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                                  text=True) for _ in range(8)]
        bad += [int(p.communicate(timeout=120)[0]) for p in procs]
    assert not any(bad), f"{sum(b > 0 for b in bad)} of 32 processes off: {bad}"
