"""The skip-link walk at the edges its warp-level CUDA kernel
(csrc/binary_walk.cu::skip_walk) must get right.

On the CPU: the plain walk (`skip_walk_plain`, what the kernel is held to
on the card) against blink's plain walks `traverse_closest` /
`traverse_anyhit` over blink's flat BVH, with lanes at t_far = 0 between
live ones, exact zero direction components (infinite inverses, NaN slabs),
rays that start inside the root box, full 16-slot leaves and a leaf of 1,
an exactly coincident pair (the lower slot wins), an any hit exactly at
t_far (it does not block) and rays blocked in the first of 2 chunks (they
do no work in the second); and ptxas's spill report for binary_walk's
kernels. On the card (gpu marker): both kernels and the counting build
against the plain walk at 1, 31, 33, 97 and 333 rays, with coherent and
random lanes in one warp and a warp whose lanes are all dead.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from blink.bvh import build_flat_bvh as jax_build_flat_bvh
from blink.kernels.traverse import traverse_anyhit, traverse_closest
from blink_torch.bvh.build import build_flat_bvh
from blink_torch.kernels import _build
from blink_torch.kernels import traverse_packed as tp
from test_bvh import _random_rays, _random_tris
from test_torch_build import port_tris

N_TRIS = 16 * 100 + 1  # 100 full leaves and a leaf of 1
PAIR = (N_TRIS - 3, N_TRIS - 2)  # triangle PAIR[1] is a copy of PAIR[0]
N_RAYS = 333  # not a multiple of 32 or of the kernel's 128-thread block
DEAD_WARP = slice(64, 96)  # a whole warp of lanes at t_far = 0
_ref_closest = jax.jit(traverse_closest)
_ref_anyhit = jax.jit(traverse_anyhit)


def edge_case():
    """(blink Triangles, packed BVH, o, d, t_far): random triangles with a
    coincident pair; rays with zero direction components, rays from inside
    the root box, a coherent fan aimed at the pair; t_far 0 on every fifth
    ray and on the lanes of DEAD_WARP, 9 elsewhere."""
    tris = _random_tris(N_TRIS, 71)
    idx = np.array(tris.idx)
    idx[PAIR[1]] = idx[PAIR[0]]
    tris = dataclasses.replace(tris, idx=jax.numpy.asarray(idx))
    verts = np.array(tris.verts)
    o, d = (np.array(a) for a in _random_rays(N_RAYS, 72))
    d[::7, 0] = 0.0
    d[::11, 1:] = 0.0
    d[::11, 0] = 1.0
    rng = np.random.default_rng(73)
    inside = slice(100, 160)
    o[inside] = rng.uniform(verts.min(0), verts.max(0), (60, 3))
    v = verts[idx[PAIR[0]]]
    pair = v.mean(0)
    normal = np.cross(v[1] - v[0], v[2] - v[0])
    fan = slice(200, 264)  # two warps of rays from just off the pair
    o[fan] = pair + 0.2 * normal / np.linalg.norm(normal)
    aim = pair[None] + np.linspace(-0.2, 0.2, 64)[:, None] * (v[1] - pair)
    d[fan] = (aim - o[fan]) / np.linalg.norm(aim - o[fan], axis=1, keepdims=True)
    t_far = np.full((N_RAYS,), 9.0, np.float32)
    t_far[::5] = 0.0
    t_far[DEAD_WARP] = 0.0
    flat = build_flat_bvh(verts, idx)
    return tris, tp.pack_bvh_planes(flat), o.astype(np.float32), d.astype(np.float32), t_far


def test_the_edge_case_has_its_edges():
    tris, pk, o, d, t_far = edge_case()
    cnt = pk.node[:, tp.COUNT].numpy()
    assert cnt.max() == 16 and (cnt == 16).sum() == 100 and (cnt == 1).sum() == 1
    lo, hi = pk.box[0, 0:3].numpy(), pk.box[0, 4:7].numpy()
    assert ((o[100:160] > lo) & (o[100:160] < hi)).all()
    assert (d == 0).any(axis=1).sum() >= 40
    # The pair sits in one leaf, in two neighbouring slots.
    slots = [int(np.nonzero(pk.tri_id.numpy() == p)[0][0]) for p in PAIR]
    assert abs(slots[0] - slots[1]) == 1


def test_plain_walk_matches_reference_at_the_edges():
    tris, pk, o, d, t_far = edge_case()
    bvh = jax_build_flat_bvh(tris)
    ot, dt, tf = (torch.from_numpy(a) for a in (o, d, t_far))
    t_ref, p_ref = (np.asarray(a) for a in _ref_closest(o, d, bvh))
    t, prim = tp.skip_walk_plain(ot, dt, pk)
    np.testing.assert_array_equal(prim.numpy(), p_ref)
    np.testing.assert_allclose(t.numpy(), t_ref, rtol=1e-6, atol=1e-6)
    # The fan reaches the pair, and the lower slot wins the exact tie.
    slot = {p: int(np.nonzero(pk.tri_id.numpy() == p)[0][0]) for p in PAIR}
    winner = min(PAIR, key=slot.get)
    assert (prim.numpy()[200:264] == winner).sum() >= 48
    assert not (prim.numpy() == max(PAIR, key=slot.get)).any()
    # t_far = 0 lanes find nothing, the others what they find without it.
    t0, p0 = tp.skip_walk_plain(ot, dt, pk, t_far=tf)
    dead = t_far == 0
    assert (p0.numpy()[dead] == -1).all() and (t0.numpy()[dead] == 0).all()
    np.testing.assert_array_equal(p0.numpy()[~dead], np.where(t_ref < 9, p_ref, -1)[~dead])
    b_ref = np.asarray(_ref_anyhit(o, d, bvh, t_far))
    blocked = tp.skip_walk_plain(ot, dt, pk, t_far=tf, any_hit=True)
    assert 0 < b_ref.sum() < N_RAYS and not b_ref[dead].any()
    np.testing.assert_array_equal(blocked.numpy(), b_ref)


def test_any_hit_exactly_at_t_far_does_not_block():
    """t_far equal to a ray's own closest t does not block it; one ulp
    more does; in the port and in blink, each with its own t."""
    tris, pk, o, d, _ = edge_case()
    bvh = jax_build_flat_bvh(tris)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    t, prim = tp.skip_walk_plain(ot, dt, pk)
    hit = prim.numpy() >= 0
    assert hit.sum() >= 20
    t_ref = np.asarray(_ref_closest(o, d, bvh)[0])
    for own, walk in ((t.numpy(), lambda tf: tp.skip_walk_plain(
            ot, dt, pk, t_far=torch.from_numpy(tf), any_hit=True).numpy()),
                      (t_ref, lambda tf: np.asarray(_ref_anyhit(o, d, bvh, tf)))):
        at = np.where(hit, own, 0.0).astype(np.float32)
        assert not walk(at).any()
        above = np.where(hit, np.nextafter(own, np.float32(np.inf)), 0.0).astype(np.float32)
        np.testing.assert_array_equal(walk(above), hit)


def test_rays_blocked_in_the_first_chunk_skip_the_second():
    """Any hit over 2 SAH chunks equals blink's over one flat BVH; a ray
    blocked in chunk 0 makes in chunk 1 no visit and no test."""
    tris = _random_tris(1200, 75)
    o, d = (np.array(a) for a in _random_rays(N_RAYS, 76))
    t_far = np.full((N_RAYS,), 6.0, np.float32)
    t_far[::3] = 0.0
    chunks = tp.build_chunked_packed(port_tris(tris), chunk_tris=600)
    assert len(chunks) == 2
    ot, dt, tf = (torch.from_numpy(a) for a in (o, d, t_far))
    b_ref = np.asarray(_ref_anyhit(o, d, jax_build_flat_bvh(tris), t_far))
    blocked, visits, tests = tp.skip_walk_plain(ot, dt, chunks, t_far=tf, any_hit=True,
                                                counts=True)
    np.testing.assert_array_equal(blocked.numpy(), b_ref)
    first, v0, q0 = tp.skip_walk_plain(ot, dt, chunks[:1], t_far=tf, any_hit=True,
                                       counts=True)
    assert 0 < first.sum() < blocked.sum()
    assert torch.equal(visits[first], v0[first]) and torch.equal(tests[first], q0[first])
    assert (visits[~first] > v0[~first]).all()
    t_ref, p_ref = (np.asarray(a) for a in _ref_closest(o, d, jax_build_flat_bvh(tris)))
    t, prim = tp.skip_walk_plain(ot, dt, chunks)
    np.testing.assert_array_equal(prim.numpy(), p_ref)
    np.testing.assert_allclose(t.numpy(), t_ref, rtol=1e-6, atol=1e-6)


#: binary_walk.cu's four kernels as g++ and nvcc mangle them.
SKIP0 = "_ZN12_GLOBAL__N_19skip_walkILb0EEEvPKfS2_PfPiPbPK6float4PK4int4S8_PKiiif"
SKIP1 = "_ZN12_GLOBAL__N_19skip_walkILb1EEEvPKfS2_PfPiPbPK6float4PK4int4S8_PKiiif"
ORD0 = "_ZN12_GLOBAL__N_112ordered_walkILb0EEEvPKfS2_PfPiPbPK6float4PK4int4S8_PKiiif"
ORD1 = "_ZN12_GLOBAL__N_112ordered_walkILb1EEEvPKfS2_PfPiPbPK6float4PK4int4S8_PKiiif"


def ptxas_entry(name, stack, stores, loads, regs):
    return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    {stack} bytes stack frame, {stores} bytes spill stores, {loads} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, used 0 barriers, {stack} bytes cumulative "
            f"stack size\n")


@pytest.mark.parametrize("text, spills", [
    # the four kernels, one of them spilling
    (ptxas_entry(SKIP0, 8, 8, 8, 40) + ptxas_entry(ORD0, 256, 0, 0, 39)
     + ptxas_entry(SKIP1, 0, 0, 0, 48) + ptxas_entry(ORD1, 256, 0, 0, 38),
     {SKIP0: 16, ORD0: 0, SKIP1: 0, ORD1: 0}),
    # the counting build's extern "C" setter is a host function: not listed
    ("ptxas info    : 0 bytes gmem\n" + ptxas_entry(SKIP1, 0, 0, 0, 72),
     {SKIP1: 0}),
    # nvcc's name for the anonymous namespace in a whole-program build
    (ptxas_entry("_ZN36_INTERNAL_0a1b2c3d_14_binary_walk_cu9skip_walkILb0EEEvPKf", 0, 4, 4, 90),
     {"_ZN36_INTERNAL_0a1b2c3d_14_binary_walk_cu9skip_walkILb0EEEvPKf": 8}),
], ids=["four-kernels", "one-kernel", "internal-namespace"])
def test_ptxas_spills_of_binary_walk(text, spills):
    assert _build.ptxas_spills(text) == spills


@pytest.mark.gpu
def test_skip_kernels_and_counting_build_match_plain_on_gpu():
    """skip_walk<false/true> and their counting build against the plain
    walk bit for bit at 1, 31, 33, 97 and 333 rays (the first n of the
    edge case: a partial last warp, coherent and random lanes in one warp,
    an all-dead warp from 97 on), with and without t_far for closest hit;
    the counting build's visits and tests equal the plain walk's ray for
    ray; rays blocked before a launch stay blocked."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, pk, o, d, t_far = edge_case()
    chunks = [pk.to("cuda")]
    for n in (1, 31, 33, 97, N_RAYS):
        ot, dt = torch.from_numpy(o[:n]).cuda(), torch.from_numpy(d[:n]).cuda()
        tf = torch.from_numpy(t_far[:n]).cuda()
        for far in (None, tf):
            t_p, prim_p, v_p, q_p = tp.skip_walk_plain(ot, dt, chunks, t_far=far, counts=True)
            t, prim = tp.traverse_closest_packed(ot, dt, chunks, t_far=far, variant="skip")
            assert torch.equal(t, t_p) and torch.equal(prim, prim_p), (n, far is None)
            (t_c, prim_c), v, q, turns, lanes = tp.skip_walk_counts(ot, dt, chunks, t_far=far)
            assert torch.equal(t_c, t_p) and torch.equal(prim_c, prim_p), n
            assert torch.equal(v, v_p) and torch.equal(q, q_p), n
            assert turns.shape == (-(-n // 32),) and (lanes <= 32 * turns).all()
        b_p, v_p, q_p = tp.skip_walk_plain(ot, dt, chunks, t_far=tf, any_hit=True, counts=True)
        blocked = tp.traverse_anyhit_packed(ot, dt, chunks, tf)
        assert torch.equal(blocked, b_p), n
        b_c, v, q, _, _ = tp.skip_walk_counts(ot, dt, chunks, t_far=tf, any_hit=True)
        assert torch.equal(b_c, b_p) and torch.equal(v, v_p) and torch.equal(q, q_p), n
    pre = torch.zeros(N_RAYS, dtype=torch.bool, device="cuda")
    pre[::4] = True
    out = pre.clone()
    ot, dt, tf = (torch.from_numpy(a).cuda() for a in (o, d, t_far))
    tp._launch("skip_anyhit", ot, dt, chunks[0], tf, out, tp.T_MIN)
    assert torch.equal(out, pre | tp.skip_walk_plain(ot, dt, chunks, t_far=tf, any_hit=True))
