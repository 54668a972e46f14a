"""blink_torch's path images and gradients against blink, on the CPU.

- Path images of Cornell 16x16 against blink's render_image: 99.9% of
  texels within atol 1e-4 (the goldens' rule), stochastic with compaction
  and Russian roulette, and deterministic without.
- Port-only exact checks: compaction and the dead-lane cull leave the image
  bit-identical.
- The sb = 4 batch loop on wide against the per-sample loop on brute.
- The albedo gradient through li_path against jax.grad.
- (slow) Russian roulette's mean against the render without it.

The BRDF helpers, compaction order and tile ids are test_torch_path.py's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blink.api import build_scene as jax_build_scene
from blink.config import get_config as jax_get_config
from blink.kernels.api import make_backend as jax_make_backend
from blink.render.api import render_image as jax_render_image
from blink_torch.api import build_scene, render
from blink_torch.config import get_config
from blink_torch.kernels.api import make_backend
from blink_torch.render import api as render_api
from blink_torch.render import integrators
from blink_torch.render.api import render_image
from blink_torch.scene.builders import bunny_scene

PATH = dict(width=16, height=16, spp=4, integrator="path", max_depth=4, backend="brute")


def _close_share(img, ref, atol=1e-4) -> float:
    assert img.shape == ref.shape and np.isfinite(img).all()
    return float(np.isclose(img, ref, atol=atol).mean())


@pytest.mark.parametrize("over", [
    dict(deterministic=False, compact=True, rr_start=1),
    dict(deterministic=True, compact=False),
], ids=["stochastic-compact-rr", "deterministic"])
def test_path_image_matches_reference(over):
    jcfg = jax_get_config("cornell").override(**PATH, **over)
    jscene = jax_build_scene(jcfg)
    jb = jax_make_backend("brute", jscene)
    ref = np.asarray(jax.jit(lambda s: jax_render_image(s, jcfg, jb))(jscene))
    cfg = get_config("cornell").override(**PATH, **over)
    img = render(build_scene(cfg), cfg, device="cpu").numpy()
    assert ref.max() > 0.01 and (ref.max(-1) > 0).mean() > 0.3
    assert _close_share(img, ref) > 0.999


def _path_image(cfg, backend_name="brute", scene=None):
    scene = build_scene(cfg) if scene is None else scene
    with torch.no_grad():
        return render_image(scene, cfg, make_backend(backend_name, scene))


def test_path_compaction_identical_image():
    cfg = get_config("cornell").override(**PATH, rr_start=1)
    plain = _path_image(cfg)
    assert plain.max() > 0.01
    assert torch.equal(_path_image(cfg.override(compact=True)), plain)


def test_path_dead_lane_cull_exact(monkeypatch):
    cfg = get_config("cornell").override(**PATH, compact=True, rr_start=1)
    on = _path_image(cfg)
    monkeypatch.setattr(integrators, "CULL_DEAD", False)
    off = _path_image(cfg)
    assert on.max() > 0.01
    assert torch.equal(on, off)


@pytest.mark.parametrize("integrator", ["direct", "path"])
def test_spp_interleaved_matches_per_sample_loop(integrator):
    """The sb = 4 batches on wide (same keys per pixel and sample) against
    the per-sample loop on brute: radiance equal but for the order of the
    f32 sum over samples (tests/test_golden.py's test of blink)."""
    scene = bunny_scene(2)
    cfg = get_config("bunny").override(width=64, height=64, spp=4, deterministic=False,
                                       seed=9, integrator=integrator, max_depth=3)
    wide = make_backend("wide", scene)
    assert render_api._spp_block(cfg, wide, render_api._tile_shape(64, 64)) == 4
    img_brute = _path_image(cfg.override(backend="brute"), "brute", scene)
    img_wide = _path_image(cfg.override(backend="wide"), "wide", scene)
    assert img_brute.max() > 0.01
    np.testing.assert_allclose(img_wide.numpy(), img_brute.numpy(), atol=2e-5)


def test_path_albedo_grad_matches_reference():
    from test_torch_grads import GRAD_TOL

    over = dict(width=16, height=16, spp=1, integrator="path", max_depth=2,
                deterministic=True, backend="brute")
    jcfg = jax_get_config("cornell").override(**over)
    jscene = jax_build_scene(jcfg)
    jb = jax_make_backend("brute", jscene)

    def jloss(albedo):
        s = jscene.replace(materials=jscene.materials.replace(albedo=albedo))
        return jnp.mean(jax_render_image(s, jcfg, jb) ** 2)

    g_ref = np.asarray(jax.jit(jax.grad(jloss))(jscene.materials.albedo))

    cfg = get_config("cornell").override(**over)
    scene = build_scene(cfg)
    albedo = scene.materials.albedo.clone().requires_grad_(True)
    s = scene.replace(materials=scene.materials.replace(albedo=albedo))
    torch.mean(render_image(s, cfg, make_backend("brute", scene)) ** 2).backward()
    rtol, atol = GRAD_TOL["albedo"]
    assert np.abs(g_ref).max() > 0
    np.testing.assert_allclose(albedo.grad.numpy(), g_ref, rtol=rtol, atol=atol)


@pytest.mark.slow
def test_russian_roulette_mean_consistency():
    """Russian roulette is unbiased: path renders with it on and off agree
    in the mean within the seed-to-seed spread (tests/test_estimators.py's
    test of blink, on the port)."""
    base = get_config("cornell").override(width=32, height=32, spp=256, deterministic=False,
                                          backend="brute", integrator="path", max_depth=4)
    scene = build_scene(base)

    def renders(rr):
        return [_path_image(base.override(rr_start=rr, seed=s), scene=scene).numpy()
                for s in (5, 17)]

    on_a, on_b = renders(1)
    off_a, off_b = renders(0)
    noise = max(np.abs(on_a - on_b).mean(), np.abs(off_a - off_b).mean())
    diff = np.abs(0.5 * (on_a + on_b) - 0.5 * (off_a + off_b)).mean()
    assert diff < 2.0 * noise + 1e-5, (diff, noise)
    assert on_a.max() > 0.05 and off_a.max() > 0.05
    # Russian roulette trades variance for work: its spread is not smaller.
    assert np.abs(on_a - on_b).mean() >= 0.5 * np.abs(off_a - off_b).mean()
