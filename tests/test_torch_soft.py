"""blink_torch's soft-silhouette gradients (sphere-soft) and the gradient
scatter against blink, on the CPU.

- Cornell 16x16, deterministic, brute, soft_sigma 0.15: the port's
  render_grad of the sphere parameters against one jax.grad of blink's
  render_image (computed once for the module), against its own hard
  gradient, and the image against the hard one.
- _sphere_soft_terms on seeded random rays, li_direct_soft through the
  wide backend's plain walks against brute's, the scatter helpers, the CLI
  flag and the dist gradients, which stay hard as blink's do.
"""
import numpy as np
import pytest
import torch

from blink.api import build_scene as jax_build_scene
from blink.api import render_grad as jax_render_grad
from blink.config import get_config as jax_get_config
from blink.diff import soft as jax_soft
from blink_torch.api import build_scene, extract_params, loss_fn, render, render_grad
from blink_torch.cli import _load_cfg, build_parser
from blink_torch.config import get_config
from blink_torch.diff import scatter_grads, scatter_grads_masked
from blink_torch.diff import soft
from blink_torch.kernels.api import make_backend
from test_torch_build import scene_numpy  # noqa: F401  (one intra-op thread)

SIZE = 16
SIGMA = 0.15
NAMES = ("sphere_center", "sphere_radius")
#: Port against blink: rtol, and atol as a share of the largest |g|. The
#: largest difference measured is 1.9e-5 of a largest |g| of 0.19 (1e-4 of
#: it); the soft terms differ by the FMA that XLA's CPU compiler contracts
#: `half_b*half_b - a*cc` into (ROADMAP.md §3), and the 256 pixels sum in
#: other orders.
GRAD_RTOL, GRAD_ATOL_SHARE = 1e-4, 4e-4


def _cfg():
    return get_config("fit").override(width=SIZE, height=SIZE, deterministic=True,
                                      backend="brute", soft_sigma=SIGMA)


@pytest.fixture(scope="module")
def reference():
    """blink's soft loss and gradients, one jax.grad for the module."""
    jcfg = jax_get_config("fit").override(width=SIZE, height=SIZE, deterministic=True,
                                          backend="brute", soft_sigma=SIGMA)
    target = np.zeros((SIZE, SIZE, 3), np.float32)
    loss, g = jax_render_grad(jax_build_scene(jcfg), jcfg, target, param_names=NAMES)
    return target, float(loss), {n: np.asarray(v) for n, v in g.items()}


def test_soft_sigma_gives_blinks_soft_gradients(reference):
    """The repaired fault: soft_sigma was ignored, so the port returned the
    hard gradient where blink returns the soft estimator's."""
    target, ref_loss, ref = reference
    cfg = _cfg()
    scene = build_scene(cfg)
    loss, g = render_grad(scene, cfg, target, NAMES, device="cpu")
    _, g_hard = render_grad(scene, cfg.override(soft_sigma=0.0), target, NAMES, device="cpu")
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-5)
    for n in NAMES:
        got, want, hard = g[n].numpy(), ref[n], g_hard[n].numpy()
        atol = GRAD_ATOL_SHARE * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=atol, err_msg=n)
        assert np.abs(hard - want).max() > 100 * atol, n  # the hard one is another
    img = render(scene, cfg, device="cpu")
    assert torch.equal(img, render(scene, cfg.override(soft_sigma=0.0), device="cpu"))


def _random_rays(n: int, seed: int):
    """Rays from around Cornell's camera towards its spheres."""
    rng = np.random.default_rng(seed)
    o = np.array([0.0, 1.4, 4.2]) + rng.uniform(-0.3, 0.3, (n, 3))
    aim = rng.uniform([-1.6, 0.0, -1.0], [1.6, 0.7, 0.8], (n, 3))
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def test_sphere_soft_terms_match_blink():
    """alpha and t_star within the FMA tolerance; idx may differ only where
    alpha or t_hit sits on its threshold (alpha > 1e-3, t_hit > RAY_EPS).
    Measured on the CPU: idx equal on all 4096 rays (none on a threshold),
    largest |d alpha| 6.0e-8, t_star identical."""
    import jax.numpy as jnp

    o, d = _random_rays(4096, 31)
    jscene = jax_build_scene(jax_get_config("fit"))
    a_ref, t_ref, i_ref = (np.asarray(x) for x in jax_soft._sphere_soft_terms(
        jnp.asarray(o), jnp.asarray(d), jscene, SIGMA))
    scene = build_scene(get_config("fit"))
    a, t, i = (x.numpy() for x in soft._sphere_soft_terms(
        torch.from_numpy(o), torch.from_numpy(d), scene, SIGMA))
    same = i == i_ref
    assert same.mean() >= 0.999, 1 - same.mean()
    assert 0.1 < (a_ref > 0.5).mean() < 0.9  # the rays straddle silhouettes
    np.testing.assert_allclose(a[same], a_ref[same], rtol=0, atol=1e-6)
    np.testing.assert_allclose(t[same], t_ref[same], rtol=1e-6, atol=1e-6)


def test_li_direct_soft_wide_equals_brute():
    """The wide backend's plain walks and sphere pass serve the soft terms
    as brute does: the same radiance and the same gradients."""
    cfg = _cfg()
    scene = build_scene(cfg)
    target = torch.zeros((SIZE, SIZE, 3))
    out = {}
    for name in ("brute", "wide"):
        backend = make_backend(name, scene)
        params = {n: v.clone().requires_grad_(True)
                  for n, v in extract_params(scene, NAMES).items()}
        loss = loss_fn(params, scene, cfg, backend, target)
        loss.backward()
        out[name] = (loss.detach(), {n: p.grad for n, p in params.items()})
    assert torch.equal(out["wide"][0], out["brute"][0])
    for n in NAMES:
        assert torch.equal(out["wide"][1][n], out["brute"][1][n]), n


def test_mesh_soft_off_without_soft_mesh():
    """soft_sigma alone leaves the rays tiled (mesh-soft needs soft_mesh):
    a triangle-only scene then takes the hard gradient."""
    from blink_torch.scene.builders import bunny_scene

    cfg = get_config("bunny").override(width=SIZE, height=SIZE, deterministic=True, spp=1,
                                       backend="brute")
    scene = bunny_scene(1)
    target = torch.zeros((SIZE, SIZE, 3))
    _, g = render_grad(scene, cfg.override(soft_sigma=1.0), target, ("tri_verts",), device="cpu")
    _, g_hard = render_grad(scene, cfg, target, ("tri_verts",), device="cpu")
    assert torch.equal(g["tri_verts"], g_hard["tri_verts"])


def test_scatter_grads_unit():
    """The values of blink's test_scatter_grads_unit: rows sum into their
    buckets, out-of-range ids are dropped, masked rays park in the
    overflow bucket, and scatter_grads is the transpose of a gather."""
    per_ray = torch.tensor([[1.0, 2.0], [10.0, 20.0], [100.0, 200.0], [0.5, 0.25]],
                           dtype=torch.float64)
    prim = torch.tensor([2, 0, 2, 5], dtype=torch.int32)  # 5 is out of range (n = 3)
    out = scatter_grads(per_ray, prim, n_prims=3).numpy()
    np.testing.assert_allclose(out, [[10.0, 20.0], [0.0, 0.0], [101.0, 202.0]])
    neg = scatter_grads(per_ray, torch.tensor([-1, 0, 2, 1], dtype=torch.int32), 3).numpy()
    np.testing.assert_allclose(neg, [[10.0, 20.0], [0.5, 0.25], [100.0, 200.0]])

    mask = torch.tensor([True, False, True, True])
    outm = scatter_grads_masked(per_ray, prim, mask, n_prims=3).numpy()
    assert outm.shape == (3, 2)
    np.testing.assert_allclose(outm, [[0.0, 0.0], [0.0, 0.0], [101.0, 202.0]])

    table = torch.arange(6, dtype=torch.float64).reshape(3, 2).requires_grad_(True)
    ids = torch.tensor([2, 0, 2, 1], dtype=torch.int32)
    (table.index_select(0, ids.long()) * per_ray).sum().backward()
    np.testing.assert_allclose(table.grad.numpy(), scatter_grads(per_ray, ids, 3).numpy())


def test_cli_soft_sigma_reaches_config():
    for argv, want in ((["fit", "--soft-sigma", "0.15"], 0.15), (["render"], 0.0)):
        args = build_parser().parse_args(argv)
        assert _load_cfg(args).soft_sigma == want


def test_dist_gradients_stay_hard():
    """blink's dist render passes no soft arguments, so dist_render_grad at
    world size 1 equals the hard render_grad under soft_sigma too."""
    from blink_torch.dist import mesh
    from blink_torch.dist.render import dist_render_grad

    cfg = _cfg()
    scene = build_scene(cfg)
    target = torch.zeros((SIZE, SIZE, 3))
    mesh.init_single_rank("gloo")
    try:
        loss_d, g_d = dist_render_grad(scene, cfg, target, NAMES, device="cpu")
    finally:
        mesh.close()
    loss_h, g_h = render_grad(scene, cfg.override(soft_sigma=0.0), target, NAMES, device="cpu")
    _, g_s = render_grad(scene, cfg, target, NAMES, device="cpu")
    np.testing.assert_allclose(loss_d.item(), loss_h.item(), rtol=1e-6)
    for n in NAMES:
        torch.testing.assert_close(g_d[n], g_h[n], rtol=1e-5, atol=1e-7)
        assert not torch.allclose(g_d[n], g_s[n], rtol=1e-3, atol=1e-4), n

