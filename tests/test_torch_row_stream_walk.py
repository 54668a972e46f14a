"""The wide walk's row, stream and skip leaf schedules at their edges
(csrc/wide_walk.cu::wide_group_walk with MODE row or stream: group's walk
reading the batch table tbat; skip: group's walk without leaf tests).

On the CPU: the plain row and stream walks (what the kernels are held to
on the card) against blink's flat-BVH walks, quantized and f32 boxes, on
the group edge case built with row tables: leaves of 44 triangles over
six 8-record batches, an exactly coincident pair, exact zero direction
components and t_far = 0 lanes; plain row's pops and tests equal plain
group's ray for ray, and plain stream pops at least group's nodes; plain
skip tests nothing, changes no hit, pops at least group's nodes and
exactly group's on the rays group finds no hit for. On the card (gpu
marker): every row, stream and skip kernel and the counting build against
the plain walks at 1, 31, 33, 97 and 333 rays, and on the late-hit rays.
The late-hit case (rays whose only hit lies in the leaf still pending when
the stream walk ends) is held to blink on the CPU by
test_torch_stream_late_hit.py; ptxas's report of the 16 wide kernels by
test_torch_wide_ptxas.py.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blink.bvh import build_flat_bvh
from blink.kernels.traverse import traverse_anyhit, traverse_closest
from blink.scene.scene import Triangles
from blink_torch.kernels import traverse_wide as tw
from blink_torch.kernels.types import T_MAX
from test_bvh import _random_rays, _random_tris
from test_torch_build import port_tris
from test_torch_group_walk import CHUNK, N_RAYS, N_TRIS, WIDE_LEAF, leaf_spans

N_SLIVERS = 1000  # triangles whose boxes hold the pending-leaf rays' line
N_LATE = 8  # rays whose only hit lies in the last leaf they reach


@functools.lru_cache(maxsize=None)
def edge_case(quant: bool):
    """The group edge case (test_torch_group_walk.edge_case) with row
    tables: random triangles with triangle N-2 a copy of N-1, two chunks
    with leaves of up to 44; rays with exact zero direction components and
    ones aimed at the coincident pair; t_far 0 on every fifth ray. Built
    once for each layout; no test changes it."""
    tris = _random_tris(N_TRIS, 61)
    verts = np.array(tris.verts)
    idx = np.array(tris.idx)
    idx[N_TRIS - 2] = idx[N_TRIS - 1]
    tris = dataclasses.replace(tris, idx=jnp.asarray(idx))
    o, d = (np.array(a) for a in _random_rays(N_RAYS, 62))
    d[::7, 0] = 0.0
    d[::11, 1:] = 0.0
    d[::11, 0] = 1.0
    pair = verts[idx[N_TRIS - 1]].mean(0)
    o[-16:] = pair + np.array([0.3, -0.2, 4.0], np.float32) * np.linspace(1, 2, 16)[:, None]
    d[-16:] = (pair - o[-16:]) / np.linalg.norm(pair - o[-16:], axis=1, keepdims=True)
    host = tw.build_chunked_wide(port_tris(tris), chunk_tris=CHUNK, wide_leaf=WIDE_LEAF,
                                 quant=quant, row_tables=True)
    t_far = np.full((N_RAYS,), 6.0, np.float32)
    t_far[::5] = 0.0
    return tris, host, o.astype(np.float32), d.astype(np.float32), t_far


@functools.lru_cache(maxsize=None)
def late_hit_case(quant: bool):
    """N_SLIVERS thin triangles in the planes x = 1 .. N_SLIVERS, each
    box holding the line y = z = 0 and no triangle touching it, then one
    triangle around it at x = N_SLIVERS + 5; rays along +x near that line
    pass every leaf's slab test, in x order, and hit only the last
    triangle, in the last leaf they reach."""
    y = np.array([-0.5, 0.6, 0.6], np.float32)  # y + z = 0.1 on the long edge
    z = np.array([0.6, -0.5, -0.4], np.float32)
    x = np.arange(1, N_SLIVERS + 1, dtype=np.float32)
    sliv = np.stack([np.broadcast_to(x[:, None], (N_SLIVERS, 3)),
                     np.broadcast_to(y, (N_SLIVERS, 3)),
                     np.broadcast_to(z, (N_SLIVERS, 3))], -1)
    x_last = N_SLIVERS + 5  # past the slivers in every octant's near-first order
    last = np.array([[x_last, -0.3, -0.3], [x_last, 0.6, -0.3], [x_last, -0.3, 0.6]],
                    np.float32)
    verts = np.concatenate([sliv.reshape(-1, 3), last]).astype(np.float32)
    idx = np.arange(verts.shape[0], dtype=np.int32).reshape(-1, 3)
    tris = Triangles(verts=jnp.asarray(verts), idx=jnp.asarray(idx),
                     uv=jnp.zeros((verts.shape[0], 2), jnp.float32),
                     material_id=jnp.zeros((idx.shape[0],), jnp.int32))
    rng = np.random.default_rng(63)
    o = np.zeros((N_LATE, 3), np.float32)
    o[:, 0] = -1.0
    o[:, 1:] = rng.uniform(-0.02, 0.02, (N_LATE, 2))
    d = np.zeros((N_LATE, 3), np.float32)
    d[:, 0] = 1.0
    d[:, 1:] = rng.uniform(-1e-5, 1e-5, (N_LATE, 2))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    host = tw.build_chunked_wide(port_tris(tris), chunk_tris=10_000, wide_leaf=WIDE_LEAF,
                                 quant=quant, row_tables=True)
    t_far = np.full((N_LATE,), 2.0 * N_SLIVERS, np.float32)
    return tris, host, o, d.astype(np.float32), t_far


@functools.lru_cache(maxsize=None)
def blink_hits(case, quant: bool):
    """blink's flat-BVH walks on `case(quant)`: (t, prim, blocked)."""
    tris, _, o, d, t_far = case(quant)
    bvh = build_flat_bvh(tris)
    t_ref, p_ref = (np.asarray(a) for a in traverse_closest(o, d, bvh))
    return t_ref, p_ref, np.asarray(traverse_anyhit(o, d, bvh, t_far))


def assert_blink_hits(case, quant: bool, mode: str, tied_prims=()):
    """The plain walk of `mode` on `case(quant)` against blink's flat-BVH
    walks: prim exactly but among `tied_prims`, t to rtol/atol 1e-6,
    blocked flags exactly."""
    _, host, o, d, t_far = case(quant)
    t_ref, p_ref, b_ref = blink_hits(case, quant)
    chunks = [tw.WideChunk.from_host(c, "cpu") for c in host]
    ot, dt, tf = torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_far)
    t, prim = tw.closest_wide_plain(ot, dt, chunks, leaf_mode=mode)
    tied = np.isin(p_ref, list(tied_prims))
    assert set(prim.numpy()[tied]) <= set(tied_prims)
    np.testing.assert_array_equal(prim.numpy()[~tied], p_ref[~tied])
    np.testing.assert_allclose(t.numpy(), t_ref, rtol=1e-6, atol=1e-6)
    blocked = tw.anyhit_wide_plain(ot, dt, chunks, tf, leaf_mode=mode)
    np.testing.assert_array_equal(blocked.numpy(), b_ref)
    return p_ref, b_ref


@pytest.mark.parametrize("quant", [True, False], ids=["quant", "f32"])
@pytest.mark.parametrize("mode", ["row", "stream"])
def test_row_stream_plain_walks_match_reference_at_the_edges(mode, quant):
    _, host, _, _, _ = edge_case(quant)
    assert len(host) == 2 and all(c.tbat is not None for c in host)
    # Some leaf of 44 triangles spans six batches of the batch table.
    assert max(int(leaf_spans(c)[1].max()) for c in host) == WIDE_LEAF
    p_ref, b_ref = assert_blink_hits(edge_case, quant, mode, (N_TRIS - 2, N_TRIS - 1))
    assert np.isin(p_ref, [N_TRIS - 2, N_TRIS - 1]).sum() >= 8  # rays reach the pair
    assert 0 < b_ref.sum() < N_RAYS and not b_ref[::5].any()


@pytest.mark.parametrize("quant", [True, False], ids=["quant", "f32"])
def test_row_counts_equal_group_and_stream_pops_a_superset(quant):
    """Plain row does group's work ray for ray (the same pops and tests);
    plain stream, whose best t arrives a leaf late, pops at least as many
    nodes as group on every ray, and somewhere more."""
    _, host, o, d, t_far = edge_case(quant)
    chunks = [tw.WideChunk.from_host(c, "cpu") for c in host]
    ot, dt, tf = torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_far)
    for far in (None, tf):
        counts = {mo: tw.closest_wide_plain(ot, dt, chunks, far, counts=True, leaf_mode=mo)[2:]
                  for mo in ("group", "row", "stream")}
        assert torch.equal(counts["row"][0], counts["group"][0])
        assert torch.equal(counts["row"][1], counts["group"][1])
        assert (counts["stream"][0] >= counts["group"][0]).all()
        assert (counts["stream"][0] > counts["group"][0]).any()
    counts = {mo: tw.anyhit_wide_plain(ot, dt, chunks, tf, counts=True, leaf_mode=mo)[1:]
              for mo in ("group", "row", "stream")}
    assert torch.equal(counts["row"][0], counts["group"][0])
    assert torch.equal(counts["row"][1], counts["group"][1])
    assert (counts["stream"][0] >= counts["group"][0]).all()


@pytest.mark.parametrize("quant", [True, False], ids=["quant", "f32"])
def test_skip_walks_group_nodes_without_leaf_tests(quant):
    """Plain skip, closest and any hit: no triangle test, t and prim as the
    ray came in (min(t_far, T_MAX), -1) and nothing blocked; its best t
    never falls, so it pops at least group's nodes on every ray, exactly
    group's where group finds no hit, and somewhere more."""
    _, host, o, d, t_far = edge_case(quant)
    chunks = [tw.WideChunk.from_host(c, "cpu") for c in host]
    ot, dt, tf = torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_far)
    for far in (None, tf):
        t, prim, pops, tests = tw.closest_wide_plain(ot, dt, chunks, far, counts=True,
                                                     leaf_mode="skip")
        _, g_prim, g_pops, _ = tw.closest_wide_plain(ot, dt, chunks, far, counts=True,
                                                     leaf_mode="group")
        t_in = torch.full_like(t, T_MAX) if far is None else torch.clamp(far, max=T_MAX)
        assert torch.equal(t, t_in) and (prim == -1).all() and not tests.any()
        miss = g_prim < 0
        assert 0 < miss.sum() < len(miss)
        assert (pops >= g_pops).all() and torch.equal(pops[miss], g_pops[miss])
        assert (pops > g_pops).any()
    blocked, pops, tests = tw.anyhit_wide_plain(ot, dt, chunks, tf, counts=True,
                                                leaf_mode="skip")
    g_blocked, g_pops, _ = tw.anyhit_wide_plain(ot, dt, chunks, tf, counts=True,
                                                leaf_mode="group")
    assert not blocked.any() and not tests.any() and g_blocked.any()
    assert (pops >= g_pops).all() and torch.equal(pops[~g_blocked], g_pops[~g_blocked])


@pytest.mark.gpu
def test_row_stream_kernels_and_counting_build_match_plain_on_gpu():
    """wide_group_walk's row, stream and skip variants, closest and any hit,
    quantized and f32 boxes, against the plain walks bit for bit at 1, 31,
    33, 97 and 333 rays of the edge case (with and without t_far for
    closest hit) and on the late-hit rays; the counting build's output,
    pops and tests equal the plain walk's ray for ray."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for quant in (True, False):
        for case, sizes in ((edge_case, (1, 31, 33, 97, N_RAYS)), (late_hit_case, (N_LATE,))):
            _, host, o, d, t_far = case(quant)
            chunks = [tw.WideChunk.from_host(c, "cuda") for c in host]
            for n, mode in ((n, mo) for n in sizes for mo in ("row", "stream", "skip")):
                ot, dt = torch.from_numpy(o[-n:]).cuda(), torch.from_numpy(d[-n:]).cuda()
                tf = torch.from_numpy(t_far[-n:]).cuda()
                for far in (None, tf):
                    t_p, prim_p, pops, tests = tw.closest_wide_plain(
                        ot, dt, chunks, t_far=far, counts=True, leaf_mode=mode)
                    t, prim = tw.traverse_closest_wide(ot, dt, chunks, t_far=far,
                                                       leaf_mode=mode)
                    assert torch.equal(t, t_p) and torch.equal(prim, prim_p), (quant, n, mode)
                    (t_c, prim_c), p, q = tw.walk_counts(False, ot, dt, chunks, far,
                                                         leaf_mode=mode)
                    assert torch.equal(t_c, t_p) and torch.equal(prim_c, prim_p)
                    assert torch.equal(p, pops) and torch.equal(q, tests), (quant, n, mode)
                b_p, pops, tests = tw.anyhit_wide_plain(ot, dt, chunks, tf, counts=True,
                                                        leaf_mode=mode)
                blocked = tw.traverse_anyhit_wide(ot, dt, chunks, tf, leaf_mode=mode)
                assert torch.equal(blocked, b_p), (quant, n, mode)
                b_c, p, q = tw.walk_counts(True, ot, dt, chunks, tf, leaf_mode=mode)
                assert torch.equal(b_c, b_p) and torch.equal(p, pops) and torch.equal(q, tests)
