"""blink_torch wide-BVH traversal against blink's flat-BVH walk.

The plain torch walk (the CPU path, and what the CUDA kernels are held
against on the card) must find the same hits as
`blink.kernels.traverse.traverse_closest`/`traverse_anyhit`: prim exactly,
t within rtol/atol 1e-6, blocked flags exactly. The Pallas wide kernel is
held to the same reference by tests/test_pallas_interpret.py.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from blink.bvh import build_flat_bvh
from blink.kernels.traverse import intersect_bvh, traverse_anyhit, traverse_closest
from blink.scene.scene import make_scene as jax_make_scene
from blink_torch.kernels import traverse_wide as tw
from blink_torch.kernels.api import make_backend
from blink_torch.kernels.types import KIND_NONE, T_MAX
from blink_torch.scene.scene import make_scene
from test_bvh import _random_rays, _random_tris
from test_torch_build import port_tris

N_RAYS = 300


def _case(ntri, seed, chunk_tris):
    tris = _random_tris(ntri, seed)
    chunks = [
        tw.WideChunk.from_host(c, "cpu")
        for c in tw.build_chunked_wide(port_tris(tris), chunk_tris=chunk_tris)
    ]
    o, d = _random_rays(N_RAYS, seed + 1)
    return tris, chunks, o, d, torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d))


@pytest.mark.parametrize(
    "ntri, seed, chunk_tris, n_chunks",
    [(64, 3, 1000, 1), (700, 5, 1000, 1), (1600, 41, 800, 2)],
)
def test_wide_plain_matches_reference(ntri, seed, chunk_tris, n_chunks):
    tris, chunks, o, d, ot, dt = _case(ntri, seed, chunk_tris)
    assert len(chunks) == n_chunks
    bvh = build_flat_bvh(tris)
    t_ref, p_ref = traverse_closest(o, d, bvh)
    t, prim = tw.traverse_closest_wide(ot, dt, chunks)
    assert (np.asarray(p_ref) >= 0).sum() >= 5  # the case has hits
    np.testing.assert_array_equal(prim.numpy(), np.asarray(p_ref))
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), rtol=1e-6, atol=1e-6)

    t_far = np.full((N_RAYS,), 5.0, np.float32)
    b_ref = np.asarray(traverse_anyhit(o, d, bvh, t_far))
    blocked = tw.traverse_anyhit_wide(ot, dt, chunks, torch.from_numpy(t_far))
    assert 0 < b_ref.sum() < N_RAYS
    np.testing.assert_array_equal(blocked.numpy(), b_ref)


def test_wide_plain_dead_lanes():
    """t_far = 0 lanes find nothing (and cost one root visit per chunk);
    the others are unaffected."""
    tris, chunks, o, d, ot, dt = _case(1600, 41, 800)
    dead = np.arange(N_RAYS) % 3 == 0
    tf = torch.from_numpy(np.where(dead, 0.0, T_MAX).astype(np.float32))
    t_ref, p_ref = traverse_closest(o, d, build_flat_bvh(tris))
    t, prim, pops, tests = tw.closest_wide_plain(ot, dt, chunks, t_far=tf, counts=True)
    assert (prim.numpy()[dead] == -1).all() and (t.numpy()[dead] == 0).all()
    np.testing.assert_array_equal(prim.numpy()[~dead], np.asarray(p_ref)[~dead])
    assert (pops.numpy()[dead] == len(chunks)).all() and (tests.numpy()[dead] == 0).all()
    assert (pops.numpy()[~dead] >= len(chunks)).all()

    t_far = np.where(dead, 0.0, 5.0).astype(np.float32)
    b_ref = np.asarray(traverse_anyhit(o, d, build_flat_bvh(tris), t_far))
    blocked = tw.traverse_anyhit_wide(ot, dt, chunks, torch.from_numpy(t_far))
    assert not blocked.numpy()[dead].any()
    np.testing.assert_array_equal(blocked.numpy(), b_ref)


def test_backend_intersect_alive_mask_matches_reference():
    tris = _random_tris(700, 9)
    o, d = _random_rays(N_RAYS, 10)
    alive = np.arange(N_RAYS) % 4 != 1
    ref = intersect_bvh(o, d, jax_make_scene(triangles=tris), build_flat_bvh(tris),
                        alive=alive)
    backend = make_backend("auto", make_scene(triangles=port_tris(tris)))
    hit = backend.intersect(torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d)),
                            make_scene(triangles=port_tris(tris)),
                            alive=torch.from_numpy(alive))
    np.testing.assert_array_equal(hit.kind.numpy(), np.asarray(ref.kind))
    np.testing.assert_array_equal(hit.prim.numpy(), np.asarray(ref.prim))
    np.testing.assert_allclose(hit.t.numpy(), np.asarray(ref.t), rtol=1e-6, atol=1e-6)
    assert (hit.kind.numpy()[~alive] == KIND_NONE).all()


def test_unported_backends_and_cuda_spheres_raise():
    """bvh is still to be ported; brute now is. Spheres no longer stop
    make_backend: on the card the sphere kernel takes them, and refuses
    more than 64 (test_torch_sphere.py's gpu test)."""
    scene = make_scene(triangles=port_tris(_random_tris(64, 2)))
    with pytest.raises(NotImplementedError, match="queue 1"):
        make_backend("bvh", scene)
    assert make_backend("brute", scene).name == "brute"
    with pytest.raises(KeyError):
        make_backend("nope", scene)


def test_port_imports_neither_jax_nor_blink():
    """The port and chip_smoke.py import torch and numpy, never JAX or the
    reference package."""
    root = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((root / "src" / "blink_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    bad = re.compile(
        r"^\s*(import jax|from jax|import blink\b(?!_)|from blink\b(?!_)|.*\btriton\b)",
        re.M,
    )
    for f in files:
        assert not bad.search(f.read_text()), f


@pytest.mark.gpu
def test_wide_kernels_match_plain_on_gpu():
    """The CUDA kernels against their plain versions on the card: t and
    prim and blocked bit for bit (same arithmetic, same visit order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, chunks, _, _, ot, dt = _case(1600, 41, 800)
    chunks = [tw.WideChunk(c.child.cuda(), c.nbox.cuda(), c.perm.cuda(),
                           c.tri.cuda(), c.tri_id.cuda(), c.max_stack) for c in chunks]
    o, d = ot.cuda(), dt.cuda()
    before = dict(tw.LAUNCHES)
    t, prim = tw.traverse_closest_wide(o, d, chunks)
    t_p, prim_p = tw.closest_wide_plain(o, d, chunks)
    assert torch.equal(t, t_p) and torch.equal(prim, prim_p)
    tf = torch.full((N_RAYS,), 5.0, device="cuda")
    tf[::3] = 0.0
    assert torch.equal(tw.traverse_anyhit_wide(o, d, chunks, tf),
                       tw.anyhit_wide_plain(o, d, chunks, tf))
    assert tw.LAUNCHES["wide_closest"] - before["wide_closest"] == 2
    assert tw.LAUNCHES["wide_anyhit"] - before["wide_anyhit"] == 2
