"""blink_torch's binary BVH walks and the `bvh` backend against blink.

- The plain skip-link and ordered walks (the CPU path, and what the CUDA
  kernels are held against on the card), closest and any hit, one BVH and
  chunked (with padded and empty chunks), against blink's plain walks
  `traverse_closest`/`traverse_anyhit` (the reference blink holds its
  Pallas walks to, tests/test_pallas_interpret.py): prim and blocked
  flags exactly, t within rtol/atol 1e-6. The reference BVHs are padded to
  one shape (blink's `_pad_flat`), so one compile of each reference walk
  serves every case. No Pallas interpret-mode call: tests/test_pallas_interpret.py
  holds those kernels to the same reference, and one such call costs more
  than this file's whole budget allows.
- The `bvh` backend's Hits and occlusion against blink's `bvh` backend on a
  small bunny and on Cornell (spheres).

The builds are held to blink's in test_torch_binary.py, whose helpers this
file imports.
"""
import jax
import numpy as np
import pytest
import torch

from blink.bvh import build_flat_bvh as jax_build_flat_bvh
from blink.dist.scene_shard import _pad_flat as jax_pad_flat
from blink.kernels.api import make_backend as jax_make_backend
from blink.kernels.traverse import traverse_anyhit, traverse_closest
from blink.scene import builders as jax_builders
from blink_torch.bvh.build import build_flat_bvh
from blink_torch.dist.scene_shard import build_sharded_chunks
from blink_torch.kernels import traverse_packed as tp
from blink_torch.kernels.api import make_backend
from blink_torch.kernels.types import KIND_SPHERE, T_MAX
from blink_torch.scene import builders
from test_bvh import _random_tris
from test_torch_binary import N_RAYS, _np, _rays, _t_far
from test_torch_build import port_tris

TOL = dict(rtol=1e-6, atol=1e-6)
WALKS = {"skip": tp.skip_walk_plain, "ordered": tp.ordered_walk_plain}
#: The shape of the 3000-triangle flat BVH, which every reference BVH is
#: padded to.
REF_NODES, REF_SLOTS = 511, 4096
_ref_closest = jax.jit(traverse_closest)
_ref_anyhit = jax.jit(traverse_anyhit)


def _reference(tris, o, d, tf):
    """blink's plain walks over blink's flat BVH of `tris`: (t, prim) of
    the closest hit and the blocked flags under t_far `tf`."""
    bvh = jax_pad_flat(jax_build_flat_bvh(tris), REF_NODES, REF_SLOTS).replace(heap2pre=None)
    t, prim = _ref_closest(o, d, bvh)
    return np.asarray(t), np.asarray(prim), np.asarray(_ref_anyhit(o, d, bvh, tf))


def _check_walks(chunks, tris, seed, t_far: bool = False):
    """Every plain walk over `chunks` against blink's plain walks over one
    flat BVH of the same triangles (random triangles: no exact ties). With
    `t_far`, the closest hits run under t_far T_MAX, 0 on every third ray."""
    o, d, ot, dt = _rays(seed)
    tf = _t_far()
    t_ref, p_ref, b_ref = _reference(tris, o, d, tf)
    assert (p_ref >= 0).sum() >= 5 and 0 < b_ref.sum() and not b_ref[::3].any()
    tf_c = None
    if t_far:
        dead = tf == 0
        tf_c = torch.from_numpy(np.where(dead, 0.0, T_MAX).astype(np.float32))
        t_ref, p_ref = np.where(dead, 0.0, t_ref), np.where(dead, -1, p_ref)
    for variant in ("skip", tp.CLOSEST_VARIANT):
        t, prim = tp.traverse_closest_packed(ot, dt, chunks, t_far=tf_c, variant=variant)
        np.testing.assert_array_equal(prim.numpy(), p_ref, err_msg=variant)
        np.testing.assert_allclose(t.numpy(), t_ref, **TOL, err_msg=variant)
    for variant in ("skip", "ordered"):
        blocked = tp.traverse_anyhit_packed(ot, dt, chunks, torch.from_numpy(tf),
                                            variant=variant)
        np.testing.assert_array_equal(blocked.numpy(), b_ref, err_msg=variant)


@pytest.mark.parametrize("ntri, seed", [(64, 3), (700, 5), (3000, 7)])
def test_plain_walks_match_reference(ntri, seed):
    tris = _random_tris(ntri, seed)
    _check_walks(tp.pack_bvh_planes(build_flat_bvh(*_np(tris))), tris, seed + 1)


def test_chunked_plain_walks_match_reference():
    """Three SAH chunks of 1000 triangles (build_chunked_packed), padded to
    one shape with an empty fourth chunk (build_sharded_chunks over 4
    shards): padding nodes are reached through skip links and must fail
    their slab test, and t_far = 0 rays must find nothing."""
    tris = _random_tris(3000, 7)
    chunks = tp.build_chunked_packed(port_tris(tris), chunk_tris=1000)
    padded, meta = build_sharded_chunks(port_tris(tris), 4, chunk_tris=1000)
    assert len(chunks) == 3 and len(padded) == 4 and meta.per_shard == 1
    assert len({c.n_nodes for c in padded}) == 1 and (padded[3].tri_id == -1).all()
    for c, p in zip(chunks, padded):
        assert c.leaf_size == p.leaf_size == 16
        n = c.n_nodes
        for f in ("box", "tri", "tri_id"):
            a, b = getattr(c, f), getattr(p, f)
            assert torch.equal(b[: a.shape[0]], a), f
        # axis and lower_first are read at internal nodes only.
        internal = c.rchild > 0
        assert torch.equal(p.node[:n, : tp.AXIS], c.node[:, : tp.AXIS])
        assert torch.equal(p.node[:n][internal], c.node[internal])
    _check_walks(padded, tris, 8, t_far=True)


def test_plain_walks_counts():
    """Counted node visits and triangle tests: a t_far = 0 ray visits each
    chunk's root and tests nothing; the empty chunk costs its root (the
    skip walk then visits one padding node); an any-hit ray blocked in
    [t_min, 5) is one whose closest hit under t_far = 5 exists, and it
    stops at that chunk's first hit."""
    tris = _random_tris(3000, 7)
    _, _, ot, dt = _rays(8)
    chunks, _ = build_sharded_chunks(port_tris(tris), 4, chunk_tris=1000)
    tf = torch.from_numpy(_t_far())
    for name, walk in WALKS.items():
        _, prim, pops, tests = walk(ot, dt, chunks, t_far=tf, counts=True)
        # The skip walk leaves a padded chunk's root for its padding nodes.
        padded = sum(int(c.skip[0]) < c.n_nodes for c in chunks)
        assert (tests.numpy()[::3] == 0).all()
        assert (pops.numpy()[::3] == 4 + (padded if name == "skip" else 0)).all(), name
        assert (pops.numpy() >= 4).all() and tests.sum() > 0, name
        _, _, p_empty, t_empty = walk(ot, dt, chunks[3:], counts=True)
        assert (t_empty == 0).all() and (p_empty == (2 if name == "skip" else 1)).all()
        b, _, btests = walk(ot, dt, chunks, t_far=tf, any_hit=True, counts=True)
        assert torch.equal(b, prim >= 0) and b.sum() > 0, name
        assert (btests.numpy()[::3] == 0).all() and (btests[b] >= 1).all()
        # One ray reads each node and slot at most once a chunk, so the
        # masks of what was read count its visits and tests; every slot
        # read holds a real triangle.
        for any_hit in (False, True):
            seen = []
            out = walk(ot[1:2], dt[1:2], chunks, t_far=tf[1:2], any_hit=any_hit,
                       counts=True, seen=seen)
            assert len(seen) == len(chunks) and all(nodes[0] for nodes, _ in seen)
            assert sum(int(nodes.sum()) for nodes, _ in seen) == int(out[-2].sum()), name
            assert sum(int(slots.sum()) for _, slots in seen) == int(out[-1].sum()) > 0, name
            assert all((c.tri_id[slots] >= 0).all() for c, (_, slots) in zip(chunks, seen))


def _backend_case(scene_name):
    """The scene in both packages and N_RAYS rays from inside it."""
    if scene_name == "bunny":
        scene, ref_scene = builders.bunny_scene(2), jax_builders.bunny_scene(2)
        rng = np.random.default_rng(4)
        o = rng.uniform([-1.5, 0.0, -1.5], [1.5, 1.5, 1.5], (N_RAYS, 3))
    else:
        scene, ref_scene = builders.cornell_box(), jax_builders.cornell_box()
        rng = np.random.default_rng(5)
        o = rng.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (N_RAYS, 3))
    d = rng.standard_normal((N_RAYS, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return scene, ref_scene, o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("scene_name", ["bunny", "cornell"])
def test_bvh_backend_matches_reference(scene_name, monkeypatch):
    """Hits with an alive mask (the live lanes are the unmasked Hits) and
    the occlusion of shadow rays from each hit towards a point above the
    scene, against blink's bvh backend. blink's walks run compiled on its
    BVH padded to the shared reference shape (the same functions, one
    compile)."""
    import blink.kernels.traverse as jax_traverse

    monkeypatch.setattr(jax_traverse, "traverse_closest", _ref_closest)
    monkeypatch.setattr(jax_traverse, "traverse_anyhit", _ref_anyhit)
    scene, ref_scene, o, d = _backend_case(scene_name)
    b, ref_b = make_backend("bvh", scene), jax_make_backend("bvh", ref_scene)
    ref_b = ref_b.replace(
        bvh=jax_pad_flat(ref_b.bvh, REF_NODES, REF_SLOTS).replace(heap2pre=None))
    assert b.name == "bvh" and len(b.chunks) == 1 and b.shade is not None
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    alive = np.arange(N_RAYS) % 4 != 1
    ref = ref_b.intersect(o, d, ref_scene, alive=alive)
    hit = b.intersect(ot, dt, scene, alive=torch.from_numpy(alive))
    np.testing.assert_array_equal(hit.kind.numpy(), np.asarray(ref.kind))
    np.testing.assert_array_equal(hit.prim.numpy(), np.asarray(ref.prim))
    np.testing.assert_allclose(hit.t.numpy(), np.asarray(ref.t), **TOL)
    assert (hit.t.numpy()[~alive] == T_MAX).all()
    assert (hit.kind.numpy() == KIND_SPHERE).any() == (scene_name == "cornell")
    t = b.intersect(ot, dt, scene).t.numpy()
    np.testing.assert_array_equal(t[alive], hit.t.numpy()[alive])
    hit_any = t < T_MAX
    assert hit_any[alive].mean() > 0.3
    p = (o + np.where(hit_any, t, 0.0)[:, None] * d - 1e-3 * d).astype(np.float32)
    to = np.float32([0.0, 1.9, 0.0]) - p
    dist = np.linalg.norm(to, axis=1)
    sd = (to / dist[:, None]).astype(np.float32)
    tf = np.where(hit_any, dist * 0.999, 0.0).astype(np.float32)
    b_ref = np.asarray(ref_b.occluded(p, sd, ref_scene, tf))
    blocked = b.occluded(torch.from_numpy(p), torch.from_numpy(sd), scene, torch.from_numpy(tf))
    assert 0 < b_ref.sum() < len(b_ref)
    np.testing.assert_array_equal(blocked.numpy(), b_ref)


@pytest.mark.gpu
def test_binary_kernels_match_plain_on_gpu():
    """The four CUDA entry points against their plain versions on the card,
    over padded chunks with an empty one: t, prim and blocked bit for bit;
    one launch per chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tris = _random_tris(3000, 7)
    _, _, ot, dt = _rays(8)
    chunks, _ = build_sharded_chunks(port_tris(tris), 4, chunk_tris=1000)
    chunks = [c.to("cuda") for c in chunks]
    o, d = ot.cuda(), dt.cuda()
    tf = torch.from_numpy(_t_far()).cuda()
    for name, walk in WALKS.items():
        variant = "skip" if name == "skip" else "ordered"
        before = dict(tp.LAUNCHES)
        t, prim = tp.traverse_closest_packed(o, d, chunks, t_far=tf, variant=variant)
        t_p, prim_p = walk(o, d, chunks, t_far=tf)
        assert torch.equal(t, t_p) and torch.equal(prim, prim_p), name
        blocked = tp.traverse_anyhit_packed(o, d, chunks, tf, variant=variant)
        assert torch.equal(blocked, walk(o, d, chunks, t_far=tf, any_hit=True)), name
        assert tp.LAUNCHES[f"{name}_closest"] - before[f"{name}_closest"] == 4
        assert tp.LAUNCHES[f"{name}_anyhit"] - before[f"{name}_anyhit"] == 4
