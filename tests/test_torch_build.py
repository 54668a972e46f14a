"""blink_torch host-side builders against blink: scenes, shading tables,
chunked quantized wide BVHs and the scene carry-over, array for array."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from blink.config import RenderConfig as JaxRenderConfig
from blink.kernels.traverse_pallas import build_chunked_wide as jax_build_chunked_wide
from blink.scene import builders as jax_builders
from blink.scene.shade import pack_tri_shade_np as jax_pack_tri_shade_np
from blink_torch.config import RenderConfig
from blink_torch.kernels.traverse_wide import build_chunked_wide
from blink_torch.scene import builders
from blink_torch.scene.scene import Triangles, scene_from_numpy
from blink_torch.scene.shade import pack_tri_shade_np
from test_bvh import _random_tris

_GROUPS = ("spheres", "triangles", "materials", "lights", "camera")


def scene_numpy(scene) -> dict:
    """A blink Scene's fields as numpy arrays (scene_from_numpy's input)."""
    d = {
        g: {f.name: np.asarray(getattr(getattr(scene, g), f.name))
            for f in dataclasses.fields(getattr(scene, g))}
        for g in _GROUPS
    }
    d["textures"] = np.asarray(scene.textures)
    return d


def port_tris(tris) -> Triangles:
    """A blink Triangles carried over to blink_torch."""
    return Triangles(**{
        f.name: torch.as_tensor(np.array(getattr(tris, f.name)))
        for f in dataclasses.fields(tris)
    })


def _assert_scene_equal(port, ref_numpy) -> None:
    for g in _GROUPS:
        for name, ref in ref_numpy[g].items():
            got = getattr(getattr(port, g), name).numpy()
            assert got.dtype == ref.dtype, (g, name, got.dtype, ref.dtype)
            assert np.array_equal(got, ref), (g, name)
    assert np.array_equal(port.textures.numpy(), ref_numpy["textures"])


@pytest.mark.parametrize(
    "name, build",
    [
        ("sponza20k", lambda m: m.sponza_scene(20_000)),
        ("bunny3", lambda m: m.bunny_scene(3)),
        ("cornell", lambda m: m.cornell_box()),
    ],
)
def test_builders_match_reference(name, build):
    ref = build(jax_builders)
    port = build(builders)
    _assert_scene_equal(port, scene_numpy(ref))
    np.testing.assert_array_equal(
        pack_tri_shade_np(port.triangles),
        np.asarray(jax_pack_tri_shade_np(ref.triangles)),
    )


def _assert_chunks_equal(ref_chunks, port_chunks) -> None:
    assert len(ref_chunks) == len(port_chunks)
    for r, p in zip(ref_chunks, port_chunks):
        assert r.quant and p.n_wide == r.n_wide and p.max_stack == r.max_stack
        np.testing.assert_array_equal(p.child, np.asarray(r.child))
        np.testing.assert_array_equal(p.nbox, np.asarray(r.nbox))
        np.testing.assert_array_equal(p.perm, np.asarray(r.perm))
        # blink's lane-slot rows hold 12 records [v0 e1 e2 tri_id] each.
        rec = np.asarray(r.trow)[:, :120].reshape(-1, 10)
        np.testing.assert_array_equal(p.tri[:, :9], rec[:, :9])
        np.testing.assert_array_equal(p.tri[:, 9:], 0.0)
        np.testing.assert_array_equal(p.tri_id, rec[:, 9].astype(np.int32))


def test_chunked_wide_random_matches_reference():
    tris = _random_tris(1600, 41)
    ref = jax_build_chunked_wide(tris, chunk_tris=800, quant=True, row_tables=False)
    port = build_chunked_wide(port_tris(tris), chunk_tris=800)
    assert len(port) == 2
    _assert_chunks_equal(ref, port)


def test_chunked_wide_sponza_chunk_order_matches_reference():
    ref_scene = jax_builders.sponza_scene(20_000)
    cam = np.asarray(ref_scene.camera.origin, np.float32)
    ref = jax_build_chunked_wide(
        ref_scene.triangles, chunk_tris=8000, wide_leaf=44, quant=True,
        row_tables=False, order_from=cam,
    )
    port = build_chunked_wide(
        port_tris(ref_scene.triangles), chunk_tris=8000, wide_leaf=44,
        order_from=cam,
    )
    assert len(port) == 3
    _assert_chunks_equal(ref, port)


def test_scene_from_numpy_round_trip():
    ref = jax_builders.cornell_box()
    d = scene_numpy(ref)
    port = scene_from_numpy(d)
    _assert_scene_equal(port, d)
    assert port.n_spheres == 8 and port.n_lights == ref.n_lights
    assert port.to("cpu").triangles.verts.dtype == torch.float32


def test_config_json_loads_in_both_packages():
    cfg = RenderConfig(scene="bunny", width=96, spp=2, backend="wide")
    assert JaxRenderConfig.from_json(cfg.to_json()).to_json() == cfg.to_json()
    ref = JaxRenderConfig(scene="sponza", width=64, deterministic=True)
    assert RenderConfig.from_json(ref.to_json()) == RenderConfig(
        **json.loads(ref.to_json())
    )
