"""blink_torch's mesh-soft gradients (SoftRas-lite, diff.soft) against
blink, on the CPU.

- bunny_scene(2) at 16x16, deterministic, brute, soft_sigma 1.0 and
  soft_mesh: the port's tri_verts gradient through render_grad against one
  jax.grad of blink's soft estimator on the same rays (computed once for
  the module), and the image against the hard one.
- Under soft_mesh the rays run in row-major pixel order with the image's
  shape, one sample a pass, at a size that the wide backend would tile.
- Port copies of blink's soft-mode camera guard and, marked slow, of its
  two recoveries (sphere positions, mesh offset); their full form runs on
  the card (chip_smoke.py's [soft] and [softmesh]).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blink.api import extract_params as jax_extract_params
from blink.api import merge_params as jax_merge_params
from blink.config import get_config as jax_get_config
from blink.kernels.api import make_backend as jax_make_backend
from blink.render.api import render_rays as jax_render_rays
from blink.render.camera import generate_rays as jax_generate_rays
from blink.scene.builders import bunny_scene as jax_bunny_scene
from blink_torch.api import build_scene, extract_params, fit, merge_params, render, render_grad
from blink_torch.config import FitConfig, get_config
from blink_torch.diff import soft
from blink_torch.kernels.api import make_backend
from blink_torch.render import api as render_api
from blink_torch.render.api import render_image
from blink_torch.render.camera import generate_rays
from blink_torch.core import sampler
from blink_torch.scene.builders import bunny_scene
from test_torch_build import scene_numpy  # noqa: F401  (one intra-op thread)

SIZE = 16
#: Port against blink: rtol, and atol as a share of the largest |g|
#: (measured on the CPU: 3.4e-7 of a largest |g| of 0.50).
GRAD_RTOL, GRAD_ATOL_SHARE = 1e-4, 1e-5


def _bunny_cfg(size=SIZE):
    return get_config("bunny").override(width=size, height=size, deterministic=True, spp=1,
                                        backend="brute")


@pytest.fixture(scope="module")
def reference():
    """blink's mesh-soft loss and tri_verts gradient, one jax.grad: blink's
    render_rays on its row-major camera rays, which is render_image's one
    sample without the sample loop (whose autodiff trace took most of the
    20 s compile)."""
    scene = jax_bunny_scene(2)
    cfg = jax_get_config("bunny").override(width=SIZE, height=SIZE, deterministic=True,
                                           spp=1, backend="brute")
    backend = jax_make_backend("brute", scene)
    x0 = jax_extract_params(scene, ("tri_verts",))["tri_verts"]

    def loss(v):
        s = jax_merge_params(scene, {"tri_verts": v})
        o, d, keys = jax_generate_rays(s.camera, SIZE, SIZE, jax.random.key(cfg.seed), 0,
                                       False)
        li = jax_render_rays(o, d, keys, s, backend, cfg.integrator, cfg.max_depth,
                             deterministic=True, soft_sigma=1.0, soft_hw=(SIZE, SIZE))
        return jnp.mean(li ** 2)

    value, g = jax.jit(jax.value_and_grad(loss))(x0)
    return float(value), np.asarray(g)


def test_mesh_soft_gradient_matches_blink(reference):
    ref_loss, ref = reference
    cfg = _bunny_cfg().override(soft_sigma=1.0, soft_mesh=True)
    scene = bunny_scene(2)
    target = torch.zeros((SIZE, SIZE, 3))
    loss, g = render_grad(scene, cfg, target, ("tri_verts",), device="cpu")
    _, g_hard = render_grad(scene, _bunny_cfg(), target, ("tri_verts",), device="cpu")
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-5)
    atol = GRAD_ATOL_SHARE * np.abs(ref).max()
    np.testing.assert_allclose(g["tri_verts"].numpy(), ref, rtol=GRAD_RTOL, atol=atol)
    assert np.abs(g_hard["tri_verts"].numpy() - ref).max() > 100 * atol
    assert torch.equal(render(scene, cfg, device="cpu"),
                       render(scene, _bunny_cfg(), device="cpu"))


def test_soft_mesh_rays_are_row_major(monkeypatch):
    """At 64x64 and 4 spp the wide backend tiles the rays and packs 4
    samples a pixel (_tile_shape, _spp_block); under soft_mesh every pass
    is one sample's rays in row-major pixel order with hw = (h, w)."""
    size = 64
    assert render_api._tile_shape(size, size) is not None
    cfg = get_config("bunny").override(width=size, height=size, spp=4, deterministic=True,
                                       backend="wide", soft_sigma=1.0, soft_mesh=True)
    scene = bunny_scene(1)
    backend = make_backend("wide", scene)
    assert render_api._spp_block(cfg, backend, render_api._tile_shape(size, size)) == 4
    calls = []

    def record(o, d, keys, scene, backend, deterministic, sigma, hw=None):
        calls.append((d.clone(), keys.clone(), hw))
        return torch.zeros_like(d)

    monkeypatch.setattr(soft, "li_direct_soft", record)
    render(scene, cfg, device="cpu", backend=backend)
    assert len(calls) == cfg.spp
    root = sampler.seed_key(cfg.seed)
    for s, (d, keys, hw) in enumerate(calls):
        _, d_rm, keys_rm = generate_rays(scene.camera, size, size, root, s, False)
        assert hw == (size, size)
        assert torch.equal(d, d_rm) and torch.equal(keys, keys_rm)


def test_soft_mesh_camera_gradient_sane():
    """blink's guard against interior-edge phantom flux: the soft-mode
    cam_look_at gradient stays within a small factor of the hard one."""
    cfg = get_config("cornell").override(width=32, height=32, deterministic=True,
                                         backend="brute")
    scene = build_scene(cfg)

    def grad_of(c):
        _, g = render_grad(scene, c, torch.zeros((32, 32, 3)), ("cam_look_at",), device="cpu")
        return g["cam_look_at"]

    g_hard = grad_of(cfg)
    g_soft = grad_of(cfg.override(soft_sigma=0.8, soft_mesh=True))
    assert torch.isfinite(g_soft).all()
    ratio = float(torch.linalg.vector_norm(g_soft) / (torch.linalg.vector_norm(g_hard) + 1e-12))
    assert ratio < 5.0, f"soft/hard grad norm ratio {ratio} (phantom flux?)"


@pytest.mark.slow
def test_fit_recovers_sphere_positions_soft():
    """Config 3 proper at blink's bounds: hard gradients cannot descend the
    position loss, soft ones recover the centres (noise from a seeded
    torch.Generator, not jax.random's numbers)."""
    cfg = get_config("fit").override(width=48, height=48, deterministic=True, backend="brute")
    scene = build_scene(cfg)
    target = render(scene, cfg, device="cpu")
    cfg_soft = cfg.override(soft_sigma=0.15)
    assert torch.equal(render(scene, cfg_soft, device="cpu"), target)
    noise = 0.08 * torch.randn(scene.spheres.center.shape,
                               generator=torch.Generator().manual_seed(11))
    scene0 = scene.replace(spheres=scene.spheres.replace(center=scene.spheres.center + noise))
    err0 = float(noise.abs().mean())
    fitted, history = fit(scene0, target, cfg_soft,
                          FitConfig(steps=120, lr=1e-2, optimize=("sphere_center",)),
                          device="cpu")
    err1 = float((fitted.spheres.center - scene.spheres.center).abs().mean())
    assert history[-1] < history[0] * 0.45, (history[0], history[-1])
    assert err1 < err0 * 0.6, (err0, err1)


@pytest.mark.slow
def test_fit_recovers_mesh_offset_soft():
    """A rigid translation of the bunny-class mesh recovered through
    tri_verts with mesh-soft gradients (50 Adam steps at lr 8e-3)."""
    scene = bunny_scene(2)
    cfg = _bunny_cfg(48)
    backend = make_backend("brute", scene)
    with torch.no_grad():
        target = render_image(scene, cfg, backend)
    cfg_soft = cfg.override(soft_sigma=1.0, soft_mesh=True)
    with torch.no_grad():
        assert torch.equal(render_image(scene, cfg_soft, backend), target)
    p0 = extract_params(scene, ("tri_verts",))["tri_verts"]
    mesh_rows = torch.zeros((p0.shape[0], 1))
    mesh_rows[8:] = 1.0  # the icosphere's rows
    p = torch.tensor([0.05, -0.03, 0.0], requires_grad=True)
    err0 = torch.linalg.vector_norm(p).item()
    opt = torch.optim.Adam([p], lr=8e-3)
    losses = []
    for _ in range(50):
        opt.zero_grad()
        s = merge_params(scene, {"tri_verts": p0 + mesh_rows * p[None, :]})
        loss = torch.mean((render_image(s, cfg_soft, backend) - target) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert torch.linalg.vector_norm(p).item() < err0 * 0.5, (err0, p)
    assert losses[-1] < losses[0] * 0.25, losses
