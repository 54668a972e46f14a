"""blink_torch's gradients against blink's, on the CPU.

- Cornell 32x32, deterministic: one port backward pass against one
  `jax.grad` over all eight array parameters, each within its stated
  tolerance.
- The bunny (320 mesh triangles) at 32x32: albedo and tri_verts through the
  port's wide backend, whose refine runs the hybrid mode, against blink's
  brute backend (as tests/test_grads_flagship.py holds blink's own pallas
  backend to brute).
- The albedo finite-difference probe of bench.py on the port alone, and
  the device rule of render_grad.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blink.api import build_scene as jax_build_scene
from blink.api import extract_params as jax_extract_params
from blink.api import merge_params as jax_merge_params
from blink.api import render_grad as jax_render_grad
from blink.config import get_config as jax_get_config
from blink.kernels.api import make_backend as jax_make_backend
from blink.render.api import render_image as jax_render_image
from blink.scene.builders import bunny_scene as jax_bunny_scene
from blink_torch.api import (
    PARAM_NAMES,
    build_scene,
    extract_params,
    fit,
    loss_fn,
    merge_params,
    params_from_numpy,
    render_grad,
)
from blink_torch.config import FitConfig, get_config
from blink_torch.diff import hitrefine
from blink_torch.kernels.api import make_backend
from blink_torch.render.api import render_image
from blink_torch.scene.builders import bunny_scene

ARRAY_PARAMS = tuple(n for n in PARAM_NAMES if n != "textures")

#: (rtol, atol) per parameter, port against blink, set at about 3x the
#: largest |diff| measured on the CPU (in brackets, against the largest
#: |g|). The two packages sum over the 1024 pixels in other orders, and
#: round the sphere quadratic differently: XLA's CPU compiler contracts
#: `half_b*half_b - a*c` into a fused multiply-add (test_torch_sphere.py),
#: which moves the radiance of sphere texels by up to 5e-5 relative, so
#: the parameters that move the spheres or aim the camera at them differ
#: most.
GRAD_TOL = {
    "albedo": (1e-4, 1e-6),  # 1.6e-7 of 0.090
    "emission": (1e-4, 1e-6),  # 7.0e-8 of 0.26
    "tri_verts": (1e-4, 1e-6),  # 1.6e-7 of 0.14
    "cam_fov": (1e-4, 3e-6),  # 9.7e-7 of 0.0061
    "cam_origin": (1e-4, 3e-5),  # 7.5e-6 of 0.10
    "cam_look_at": (1e-4, 1e-4),  # 3.1e-5 of 0.28
    "sphere_center": (1e-4, 1e-4),  # 3.6e-5 of 0.059
    "sphere_radius": (1e-4, 1e-4),  # 4.0e-5 of 0.052
}


def test_all_array_param_grads_match_reference_on_cornell():
    jcfg = jax_get_config("cornell").override(width=32, height=32, deterministic=True)
    target = np.zeros((32, 32, 3), np.float32)
    ref_loss, ref = jax_render_grad(jax_build_scene(jcfg), jcfg, target,
                                    param_names=ARRAY_PARAMS)
    cfg = get_config("cornell").override(width=32, height=32, deterministic=True)
    scene = build_scene(cfg)
    backend = make_backend(cfg.backend, scene)
    assert backend.name == "brute"
    params = {n: v.clone().requires_grad_(True)
              for n, v in extract_params(scene, ARRAY_PARAMS).items()}
    loss = loss_fn(params, scene, cfg, backend, torch.from_numpy(target))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    for n in ARRAY_PARAMS:
        g, g_ref = params[n].grad.numpy(), np.asarray(ref[n])
        rtol, atol = GRAD_TOL[n]
        assert np.abs(g_ref).max() > 0, n
        np.testing.assert_allclose(g, g_ref, rtol=rtol, atol=atol, err_msg=n)


def test_hybrid_mode_grads_match_reference_brute_on_bunny(monkeypatch):
    """albedo and tri_verts of the bunny at 32x32 through the port's wide
    backend (hybrid refine: uv and material from the table, vertices
    gathered live) against blink's brute backend."""
    jcfg = jax_get_config("bunny").override(width=32, height=32, deterministic=True, spp=1)
    jscene = jax_bunny_scene(subdiv=2)
    jb = jax_make_backend("brute", jscene)

    def jloss(albedo, tv):
        s = jax_merge_params(jscene, {"albedo": albedo, "tri_verts": tv})
        return jnp.mean(jax_render_image(s, jcfg, jb) ** 2)

    p = jax_extract_params(jscene, ("albedo", "tri_verts"))
    ga_ref, gv_ref = jax.grad(jloss, argnums=(0, 1))(p["albedo"], p["tri_verts"])

    gathers = []
    orig = hitrefine._GatherTriVerts.apply
    monkeypatch.setattr(hitrefine._GatherTriVerts, "apply",
                        lambda *a: gathers.append(1) or orig(*a))
    scene = bunny_scene(subdiv=2)
    cfg = get_config("bunny").override(width=32, height=32, deterministic=True, spp=1,
                                       backend="wide")
    backend = make_backend("wide", scene)
    params = params_from_numpy({k: np.asarray(v) for k, v in p.items()}, "cpu")
    for v in params.values():
        v.requires_grad_(True)
    merged = merge_params(scene, params)
    assert merged.geom_dirty and backend.shade is not None
    loss = torch.mean(render_image(merged, cfg, backend) ** 2)
    loss.backward()
    assert gathers  # the hybrid mode ran
    ga, gv = params["albedo"].grad.numpy(), params["tri_verts"].grad.numpy()
    assert np.abs(ga).max() > 0 and np.abs(gv).max() > 0
    np.testing.assert_allclose(ga, np.asarray(ga_ref), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(gv, np.asarray(gv_ref), rtol=1e-4, atol=1e-6)


def test_albedo_fd_probe_on_port():
    """bench.py's probe on the port: the 3 largest albedo gradients against
    f32 central differences (albedo enters the image linearly), rel < 0.05."""
    cfg = get_config("cornell").override(width=32, height=32, deterministic=True)
    scene = build_scene(cfg)
    backend = make_backend("brute", scene)
    target = torch.zeros(32, 32, 3)
    _, g = render_grad(scene, cfg, target, ("albedo",), device="cpu", backend=backend)
    g = g["albedo"].numpy()
    x0 = scene.materials.albedo

    def loss(a):
        with torch.no_grad():
            return float(loss_fn({"albedo": a}, scene, cfg, backend, target))

    for fi in np.argsort(-np.abs(g).ravel())[:3]:
        e = torch.zeros(x0.numel())
        e[fi] = 1e-2
        e = e.reshape(x0.shape)
        fd = (loss(x0 + e) - loss(x0 - e)) / 2e-2
        assert abs(g.ravel()[fi] - fd) / max(abs(fd), 1e-6) < 0.05, (fi, g.ravel()[fi], fd)


def test_render_grad_default_device_needs_cuda(monkeypatch):
    """render_grad and fit, like render, raise without a CUDA device unless
    the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("cornell").override(width=8, height=8)
    scene = build_scene(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        render_grad(scene, cfg, torch.zeros(8, 8, 3))
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        render_grad(scene, cfg, torch.zeros(8, 8, 3), device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit(scene, torch.zeros(8, 8, 3), cfg, FitConfig(steps=1))
