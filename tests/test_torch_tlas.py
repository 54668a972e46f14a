"""blink_torch's two-level BVH (bvh.tlas), the instanced Sponza builder and
the TLAS probe against blink and against the port's flat walks, on the
CPU."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blink.bvh.tlas import build_two_level as jax_build_two_level
from blink.bvh.tlas import traverse_two_level as jax_traverse_two_level
from blink.scene.builders import sponza_scene_instanced as jax_sponza_scene_instanced
from blink_torch.benchmarks import tlas_probe
from blink_torch.bvh.tlas import build_two_level, instance_scene_triangles, traverse_two_level
from blink_torch.kernels.api import make_backend
from blink_torch.kernels.traverse_wide import traverse_closest_wide
from blink_torch.kernels.types import T_MAX
from blink_torch.scene.builders import sponza_scene_instanced
from blink_torch.scene.scene import make_scene
from test_tlas import _make_instanced
from test_torch_build import _assert_scene_equal, port_tris, scene_numpy


def _assert_tlas_equal(port, ref) -> None:
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if isinstance(got, torch.Tensor):
            want = np.asarray(want)
            assert got.numpy().dtype == want.dtype, f.name
            assert np.array_equal(got.numpy(), want), f.name
        else:
            assert got == want, f.name


@pytest.fixture(scope="module")
def instanced():
    """_make_instanced's objects (blink's and the port's), its two-level
    structures, and 512 seeded random rays."""
    objects, insts, o2w = _make_instanced()
    rng = np.random.default_rng(9)
    o = rng.uniform(-6, 6, (512, 3)).astype(np.float32)
    d = rng.standard_normal((512, 3)).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    port_objects = [port_tris(t) for t in objects]
    return (objects, port_objects, insts, o2w, jax_build_two_level(objects, insts, o2w),
            build_two_level(port_objects, insts, o2w), o, d)


def test_build_two_level_matches_reference(instanced):
    _, _, _, _, ref, port, _, _ = instanced
    _assert_tlas_equal(port, ref)


def test_sponza_instanced_matches_reference():
    """sponza_scene_instanced(8_000): objects, instances, the flattened
    scene and the two-level structure over them, array for array."""
    j_objects, j_insts, j_o2w, j_scene = jax_sponza_scene_instanced(8_000)
    objects, insts, o2w, scene = sponza_scene_instanced(8_000)
    assert insts.dtype == np.asarray(j_insts).dtype and np.array_equal(insts, j_insts)
    assert o2w.dtype == j_o2w.dtype and np.array_equal(o2w, j_o2w)
    assert len(objects) == len(j_objects)
    for p, r in zip(objects, j_objects):
        for f in ("verts", "idx", "uv", "material_id"):
            assert np.array_equal(getattr(p, f).numpy(), np.asarray(getattr(r, f))), f
    _assert_scene_equal(scene, scene_numpy(j_scene))
    _assert_tlas_equal(build_two_level(objects, insts, o2w),
                       jax_build_two_level(j_objects, j_insts, j_o2w))


def test_traverse_two_level_matches_reference_and_brute(instanced):
    """blink's walk: prim exact, t within 1e-6 (the instance transforms
    round in another order). The port's brute backend over the flattened
    triangles: test_tlas.py's rule."""
    _, objects, insts, o2w, ref, acc, o, d = instanced
    t_ref, p_ref = (np.asarray(x) for x in jax_traverse_two_level(jnp.asarray(o),
                                                                  jnp.asarray(d), ref))
    t, p = traverse_two_level(torch.from_numpy(o), torch.from_numpy(d), acc)
    assert t.dtype == torch.float32 and p.dtype == torch.int32
    assert (p_ref >= 0).mean() > 0.05
    assert np.array_equal(p.numpy(), p_ref)
    np.testing.assert_allclose(t.numpy(), t_ref, rtol=1e-6, atol=1e-6)

    scene = make_scene(triangles=instance_scene_triangles(objects, insts, o2w))
    hb = make_backend("brute", scene).intersect(torch.from_numpy(o), torch.from_numpy(d), scene)
    hit_b = (hb.t < 0.99 * T_MAX).numpy()
    assert np.array_equal(p.numpy() >= 0, hit_b)
    np.testing.assert_allclose(t.numpy()[hit_b], hb.t.numpy()[hit_b], rtol=1e-4, atol=1e-4)
    assert (p.numpy()[hit_b] == hb.prim.numpy()[hit_b]).mean() > 0.99


def test_instanced_sponza_two_level_matches_flat():
    """The two-level walk on the instanced hall against the production flat
    walk (the wide backend's chunks; their plain walk here) over the
    flattened triangles: test_tlas.py's rule (hits equal, t within 1e-5)."""
    objects, insts, o2w, scene = sponza_scene_instanced(8_000)
    acc = build_two_level(objects, insts, o2w)
    o, d = tlas_probe.probe_rays(256, "cpu")
    t_fl, p_fl = traverse_closest_wide(o, d, make_backend("pallas", scene).chunks)
    t_tl, p_tl = traverse_two_level(o, d, acc)
    hit = p_fl >= 0
    assert hit.float().mean() > 0.3  # the scene is in view
    assert torch.equal(hit, p_tl >= 0)
    torch.testing.assert_close(t_tl[hit], t_fl[hit], rtol=1e-5, atol=1e-5)


def test_tlas_probe_on_cpu(capsys):
    """The probe's JSON line at toy size on the CPU (its times mean
    something only on the card)."""
    import json

    assert tlas_probe.main(["--tris", "8000", "--rays", "512", "--reps", "1",
                            "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["platform"] == "cpu" and out["parity_exact_hits"] is True
    assert out["n_triangles"] == 5130 and out["n_instances"] == 5
    for side in ("two_level", "flat"):
        assert out[side]["rays_per_s"] > 0 and out[side]["structure_mb"] > 0
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            tlas_probe.run(8_000, 16, 1)
