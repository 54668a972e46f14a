"""blink_torch's random streams, ray generation, light sampling and hit
refinement against blink.

The sampler's uint32 hashing must be bit-identical (blink_torch computes it
in int64 with a 32-bit mask), and so must every key and jitter draw of
generate_rays, in any ray order. Light samples and refined hits agree at
atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blink.core import sampler as jax_sampler
from blink.diff.hitrefine import refine as jax_refine
from blink.kernels.types import Hit as JaxHit
from blink.render import api as jax_render_api
from blink.render.camera import generate_rays as jax_generate_rays
from blink.sampling.lights import sample_light_point as jax_sample_light_point
from blink.scene import builders as jax_builders
from blink.scene.scene import derive_lights as jax_derive_lights
from blink.scene.shade import pack_tri_shade as jax_pack_tri_shade
from blink_torch.core import sampler
from blink_torch.diff.hitrefine import refine
from blink_torch.kernels.types import KIND_NONE, KIND_SPHERE, KIND_TRI, Hit
from blink_torch.render import api as render_api
from blink_torch.render.camera import generate_rays
from blink_torch.sampling.lights import sample_light_point
from blink_torch.scene.scene import scene_from_numpy
from blink_torch.scene.shade import pack_tri_shade_np
from test_torch_build import scene_numpy

ATOL = 1e-6


def _u32(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _eq_u32(port: torch.Tensor, ref) -> None:
    np.testing.assert_array_equal(port.numpy().astype(np.uint32), np.asarray(ref))


def test_hash_chain_bit_identical():
    rng = np.random.default_rng(0)
    x = _u32(rng, 4096)
    x[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    xt = torch.from_numpy(x.astype(np.int64))
    _eq_u32(sampler._mix(xt), jax_sampler._mix(jnp.asarray(x)))
    _eq_u32(sampler._mix2(xt), jax_sampler._mix2(jnp.asarray(x)))

    key = _u32(rng, (4096, 2))
    data = _u32(rng, 4096)
    kt = torch.from_numpy(key.astype(np.int64))
    dt = torch.from_numpy(data.astype(np.int64))
    folded = jax_sampler.fold(jnp.asarray(key), jnp.asarray(data))
    _eq_u32(sampler.fold(kt, dt), folded)
    _eq_u32(sampler.bounce_key(kt, 3), jax_sampler.bounce_key(jnp.asarray(key), 3))
    for n, dim in ((1, 0), (3, 0), (2, 1), (16, 2)):
        ref = jax.vmap(lambda k: jax_sampler.uniform(k, (n,), dim=dim))(jnp.asarray(key))
        np.testing.assert_array_equal(
            sampler.uniform(kt, n, dim=dim).numpy(), np.asarray(ref)
        )


@pytest.mark.parametrize("seed", [0, 7, 123_456_789])
def test_seed_key_matches_typed_jax_key(seed):
    ref = jax_sampler._seed_key(jax.random.key(seed))
    _eq_u32(sampler.seed_key(seed), ref)


@pytest.mark.parametrize(
    "h, w, order",
    [(64, 64, "tiles"), (32, 128, "tiles"), (24, 40, "rows")],
)
def test_generate_rays_keys_and_jitter_bit_identical(h, w, order):
    """Pixel and block streams, jitter and rays, in tile order (64x64 tiles
    of 32x32 blocks, or 32x128 strips) or row-major."""
    seed, sample = 11, 2
    ref_scene = jax_builders.sponza_scene(2_000)
    port_scene = scene_from_numpy(scene_numpy(ref_scene))
    if order == "tiles":
        tile = render_api._tile_shape(h, w)
        assert tile == jax_render_api._tile_shape(h, w)
        pid = render_api.tile_pixel_ids(h, w, *tile)
        pid_ref = jax_render_api.tile_pixel_ids(h, w, *tile)
        np.testing.assert_array_equal(pid.numpy(), np.asarray(pid_ref))
    else:
        assert render_api._tile_shape(h, w) is None
        pid, pid_ref = None, None
    o_ref, d_ref, k_ref = jax_generate_rays(
        ref_scene.camera, h, w, jax.random.key(seed), sample, True, pixel_id=pid_ref
    )
    root = sampler.seed_key(seed)
    o, d, keys = generate_rays(port_scene.camera, h, w, root, sample, True, pixel_id=pid)
    _eq_u32(keys, k_ref)
    ref_uv = jax.vmap(lambda k: jax_sampler.uniform(k, (2,), dim=0))(k_ref[:, :2])
    np.testing.assert_array_equal(
        sampler.uniform(keys[:, :2], 2, dim=0).numpy(), np.asarray(ref_uv)
    )
    np.testing.assert_array_equal(o.numpy(), np.asarray(o_ref))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=0, atol=ATOL)
    if order == "tiles":
        img = torch.arange(h * w * 3, dtype=torch.float32).reshape(h * w, 3)
        back = render_api.untile_image(img, h, w, *tile)
        ref_back = jax_render_api.untile_image(jnp.asarray(img.numpy()), h, w, *tile)
        np.testing.assert_array_equal(back.numpy(), np.asarray(ref_back))


def _cornell_with_sphere_light():
    """Cornell box with sphere 0 made emissive, so that lights hold both
    kinds (triangle and sphere)."""
    ref = jax_builders.cornell_box()
    mid = np.asarray(ref.spheres.material_id).copy()
    mid[0] = 1  # the emissive material
    spheres = ref.spheres.replace(material_id=jnp.asarray(mid))
    lights = jax_derive_lights(ref.materials, spheres, ref.triangles)
    return ref.replace(spheres=spheres, lights=lights)


def test_sample_light_point_matches_reference():
    ref = _cornell_with_sphere_light()
    port = scene_from_numpy(scene_numpy(ref))
    assert sorted(set(np.asarray(ref.lights.kind).tolist())) == [0, 1]
    rng = np.random.default_rng(5)
    n = 2000
    light = rng.integers(0, ref.n_lights, n).astype(np.int32)
    u1, u2 = rng.random((2, n), dtype=np.float32)
    got = sample_light_point(port, torch.from_numpy(light), torch.from_numpy(u1),
                             torch.from_numpy(u2))
    want = jax_sample_light_point(ref, jnp.asarray(light), jnp.asarray(u1), jnp.asarray(u2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def test_refine_matches_reference():
    """Both branches (sphere and shade-table triangle) and misses, on rays
    aimed at the primitive each Hit names."""
    ref = jax_builders.cornell_box()
    port = scene_from_numpy(scene_numpy(ref))
    rng = np.random.default_rng(8)
    n = 3000
    kind = rng.choice([KIND_NONE, KIND_SPHERE, KIND_TRI], n).astype(np.int32)
    prim = np.where(
        kind == KIND_SPHERE,
        rng.integers(0, ref.n_spheres, n),
        rng.integers(0, ref.n_triangles, n),
    ).astype(np.int32)
    verts = np.asarray(ref.triangles.verts)
    idx = np.asarray(ref.triangles.idx)
    bary = rng.dirichlet([2.0, 2.0, 2.0], n).astype(np.float32)
    target = np.einsum("nk,nkc->nc", bary, verts[idx[np.clip(prim, 0, len(idx) - 1)]])
    centers = np.asarray(ref.spheres.center)
    target = np.where((kind == KIND_SPHERE)[:, None],
                      centers[np.clip(prim, 0, ref.n_spheres - 1)], target)
    o = np.asarray(ref.camera.origin)[None] + rng.normal(0.0, 0.2, (n, 3)).astype(np.float32)
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = np.full(n, 1e30, np.float32)

    want = jax_refine(jnp.asarray(o), jnp.asarray(d),
                      JaxHit(t=jnp.asarray(t), kind=jnp.asarray(kind), prim=jnp.asarray(prim)),
                      ref, shade=jax_pack_tri_shade(ref.triangles))
    got = refine(torch.from_numpy(o), torch.from_numpy(d),
                 Hit(t=torch.from_numpy(t), kind=torch.from_numpy(kind),
                     prim=torch.from_numpy(prim)),
                 port, shade=torch.from_numpy(pack_tri_shade_np(port.triangles)))
    valid = np.asarray(want.valid)
    assert valid.sum() > n // 2
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.mat.numpy(), np.asarray(want.mat))
    for name in ("t", "p", "n", "uv", "albedo", "emission"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            rtol=1e-6, atol=ATOL, err_msg=name,
        )
