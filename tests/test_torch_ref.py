"""blink_torch.ref, the port's copy of blink's numpy oracle, against
blink.ref, and the port's render against its own oracle, on the CPU.

Both oracles are float64 numpy over the same float32 scene arrays, so
their images and central differences are held equal exactly.
"""
import numpy as np
import pytest
import torch

from blink.ref import fd_grad as jax_fd_grad
from blink.ref import ref_render as jax_ref_render
from blink.scene import builders as jax_builders
from blink_torch.api import render
from blink_torch.config import get_config
from blink_torch.ref import fd_grad, ref_render
from blink_torch.scene import builders
from test_torch_build import scene_numpy  # noqa: F401  (one intra-op thread)

SIZE = 32
SCENES = {"cornell": (builders.cornell_box, jax_builders.cornell_box),
          "bunny2": (lambda: builders.bunny_scene(2), lambda: jax_builders.bunny_scene(2))}


@pytest.fixture(scope="module", params=sorted(SCENES))
def oracles(request):
    """(name, port scene, the port oracle's image, blink's)."""
    port, jax = SCENES[request.param]
    scene = port()
    return request.param, scene, ref_render(scene, SIZE, SIZE), jax_ref_render(jax(), SIZE, SIZE)


def test_ref_render_equals_blinks(oracles):
    name, _, img, ref = oracles
    assert img.dtype == ref.dtype == np.float32 and img.shape == (SIZE, SIZE, 3)
    assert (img.max(axis=-1) > 0).mean() > 0.3, name  # the frame is lit
    assert np.array_equal(img, ref), (name, np.abs(img - ref).max())


@pytest.mark.parametrize("backend", ["brute", "wide"])
def test_render_matches_own_oracle(oracles, backend):
    """tests/test_golden.py's rule: 99.9% of texels within 1e-4 and a mean
    error under 1e-4."""
    name, scene, ref, _ = oracles
    preset = "cornell" if name == "cornell" else "bunny"
    cfg = get_config(preset).override(width=SIZE, height=SIZE, spp=1, deterministic=True,
                                      backend=backend)
    img = render(scene, cfg, device="cpu").numpy()
    close = np.isclose(img, ref, atol=1e-4)
    assert close.mean() > 0.999, (name, backend, close.mean())
    assert np.abs(img - ref).mean() < 1e-4, (name, backend)


def test_fd_grad_equals_blinks():
    """The same central differences, on a smooth function and on a loss of
    the port's oracle (the albedo of Cornell's floor at 8x8)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 2))
    f = lambda v: float(np.sum(np.sin(v) * v ** 2))  # noqa: E731
    g = fd_grad(f, x, eps=1e-4)
    assert np.array_equal(g, jax_fd_grad(f, x, eps=1e-4))
    np.testing.assert_allclose(g, np.cos(x) * x ** 2 + 2 * x * np.sin(x), rtol=1e-6)

    scene = builders.cornell_box()
    albedo = scene.materials.albedo

    def loss(a):
        s = scene.replace(materials=scene.materials.replace(
            albedo=torch.from_numpy(a.astype(np.float32))))
        return float(np.mean(ref_render(s, 8, 8) ** 2))

    x0 = albedo[0].numpy().astype(np.float64)
    g = fd_grad(lambda v: loss(np.concatenate([v[None], albedo[1:].numpy()])), x0, eps=1e-2)
    g_ref = jax_fd_grad(lambda v: loss(np.concatenate([v[None], albedo[1:].numpy()])), x0,
                        eps=1e-2)
    assert np.array_equal(g, g_ref) and (g > 0).all()
