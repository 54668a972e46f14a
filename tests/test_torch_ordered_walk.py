"""The ordered walk at the edges its CUDA kernel
(csrc/binary_walk.cu::ordered_walk) must get right.

On the CPU: the plain walk (`ordered_walk_plain`, what the kernel is held
to on the card) against blink's plain walks `traverse_closest` /
`traverse_anyhit`, on test_torch_skip_walk's edge case (lanes at t_far = 0
and a dead warp, zero direction components, origins inside the root box,
full leaves and a leaf of 1, a coincident pair); a direction component of
exactly +0.0 and -0.0, which take the same near child; a tree whose root is
a leaf; a tree at the deepest depth `_check_depth` admits, whose walk fills
the kernel's stack; an any hit whose tests end at its first hit; the step
hook the nested-loop model reads; and ptxas's report of an ordered_walk
with a stack frame but no spills. On the card (gpu marker): both kernels
and the counting build against the plain walk at 1, 31, 33, 97 and 333
rays, with coherent and random lanes in one warp and a warp whose lanes
are all dead, and on the trees above.
"""
import jax
import numpy as np
import pytest
import torch

from blink.bvh import build_flat_bvh as jax_build_flat_bvh
from blink.scene.scene import Triangles
from blink.kernels.traverse import traverse_anyhit, traverse_closest
from blink_torch.bvh.build import build_flat_bvh
from blink_torch.bvh.types import FlatBVH
from blink_torch.kernels import _build
from blink_torch.kernels import traverse_packed as tp
from test_torch_skip_walk import DEAD_WARP, N_RAYS, ORD0, ORD1, SKIP0, edge_case, ptxas_entry

_ref_closest = jax.jit(traverse_closest)
_ref_anyhit = jax.jit(traverse_anyhit)


def blink_tris(verts, idx):
    jnp = jax.numpy
    return Triangles(verts=jnp.asarray(verts), idx=jnp.asarray(idx, jnp.int32),
                     uv=jnp.zeros((verts.shape[0], 2), jnp.float32),
                     material_id=jnp.zeros((idx.shape[0],), jnp.int32))


def assert_matches_blink(o, d, t_far, pk, tris):
    """The plain ordered walk over `pk` against blink's plain walks over its
    own flat BVH of the same triangles: prim and blocked exactly, t within
    1e-6; closest hit with and without t_far."""
    bvh = jax_build_flat_bvh(tris)
    ot, dt, tf = (torch.from_numpy(a) for a in (o, d, t_far))
    t_ref, p_ref = (np.asarray(a) for a in _ref_closest(o, d, bvh))
    t, prim = tp.ordered_walk_plain(ot, dt, pk)
    np.testing.assert_array_equal(prim.numpy(), p_ref)
    np.testing.assert_allclose(t.numpy(), t_ref, rtol=1e-6, atol=1e-6)
    _, p0 = tp.ordered_walk_plain(ot, dt, pk, t_far=tf)
    live = t_far > 0
    assert (p0.numpy()[~live] == -1).all()
    np.testing.assert_array_equal(p0.numpy()[live],
                                  np.where(t_ref < t_far, p_ref, -1)[live])
    b_ref = np.asarray(_ref_anyhit(o, d, bvh, t_far))
    np.testing.assert_array_equal(tp.ordered_walk_plain(ot, dt, pk, t_far=tf,
                                                        any_hit=True).numpy(), b_ref)
    return p_ref, b_ref


def test_plain_walk_matches_reference_at_the_edges():
    tris, pk, o, d, t_far = edge_case()
    p_ref, b_ref = assert_matches_blink(o, d, t_far, pk, tris)
    assert (p_ref >= 0).sum() >= 60 and 0 < b_ref.sum() < N_RAYS
    assert not b_ref[DEAD_WARP].any()


# Two triangles that meet on the line x = 1 of the plane z = 5, each in a
# leaf of its own (leaf size 1): the left one over x in [0, 1], the right
# one over [1, 2]. A ray down the line hits both at t = 5 exactly, so the
# leaf the walk tests first, its near child, wins the tie.
PAIR_VERTS = np.array([[0, -1, 5], [1, -1, 5], [1, 1, 5],
                       [1, -1, 5], [2, -1, 5], [1, 1, 5]], np.float32)


def pair_tree():
    pk = tp.pack_bvh_planes(build_flat_bvh(PAIR_VERTS, np.arange(6).reshape(2, 3),
                                           leaf_size=1))
    node = pk.node.numpy()
    assert pk.n_nodes == 3 and node[0, tp.AXIS] == 0 and node[0, tp.RCHILD] == 2
    assert (node[1:, tp.COUNT] == 1).all()
    return pk


#: Rays down the shared line: d.x = +0.0 and -0.0 from below, and one with
#: d.x < 0 that crosses the line at t = 5 (every product exact in f32).
PAIR_O = [[1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [6.0, 0.0, 0.0]]
PAIR_D = [[0.0, 0.0, 1.0], [-0.0, 0.0, 1.0], [-1.0, 0.0, 1.0]]


def test_signed_zero_directions_take_the_same_near_child():
    """d.x = +0.0 and -0.0 both take the lower-x child first (-0.0 counts as
    positive) and so find the left triangle; d.x < 0 takes the other child
    first and finds the right one. Pops and tests are the same for all
    three; t is 5 for all three."""
    pk = pair_tree()
    node = pk.node.numpy()
    lower = int(pk.tri_id[node[1 if node[0, tp.LOWER_FIRST] else 2, tp.FIRST]])
    left = int(pk.tri_id[node[1, tp.FIRST]])
    o, d = torch.tensor(PAIR_O), torch.tensor(PAIR_D)
    assert torch.signbit(d[1, 0]) and not torch.signbit(d[0, 0])
    t, prim, pops, tests = tp.ordered_walk_plain(o, d, pk, counts=True)
    assert t.tolist() == [5.0, 5.0, 5.0] and prim.tolist() == [lower, lower, 1 - lower]
    assert pops.tolist() == [3, 3, 3] and tests.tolist() == [2, 2, 2]
    # The skip-link walk tests the left leaf first, whatever the direction.
    assert tp.skip_walk_plain(o, d, pk)[1].tolist() == [left] * 3


def root_leaf_case():
    """(blink Triangles, packed BVH, o, d, t_far, first hit slot): 16
    parallel triangles in one leaf (the root is the leaf), at z = 1..16 in a
    shuffled order; rays along +z through them, and rays that miss; t_far
    20, 0 or 1.5."""
    rng = np.random.default_rng(86)
    z = rng.permutation(16) + 1.0
    verts = np.zeros((16, 3, 3), np.float32)
    verts[:, :, 2] = z[:, None]
    verts[:, 1, 0] = verts[:, 2, 1] = 4.0
    verts[:, 0, :2] = -1.0
    verts[:, :, 0] += rng.permutation(16)[:, None] / 64  # slot order is not z order
    verts = verts.reshape(-1, 3)
    idx = np.arange(48).reshape(16, 3)
    pk = tp.pack_bvh_planes(build_flat_bvh(verts, idx))
    assert pk.n_nodes == 1 and int(pk.node[0, tp.COUNT]) == 16
    n = 40
    o = np.zeros((n, 3), np.float32)
    o[:, :2] = rng.uniform(-0.5, 0.5, (n, 2))
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    o[::4, 0] = 9.0  # misses every triangle
    t_far = np.full((n,), 20.0, np.float32)
    t_far[1::4] = 0.0
    t_far[2::4] = 1.5  # only the triangle at z = 1 blocks, in whatever slot
    # The first slot holding a triangle below t_far, where an any hit stops.
    slot_z = z[pk.tri_id.numpy()]
    first = np.array([int(np.argmax(slot_z < tf)) for tf in t_far])
    return blink_tris(verts, idx), pk, o, d, t_far, first


def test_root_leaf_tree():
    """A tree of one leaf: every ray pops the root once; the closest hit is
    the lowest triangle; an any hit stops at the first slot below its
    t_far, so its tests count that slot's position plus one."""
    tris, pk, o, d, t_far, first = root_leaf_case()
    p_ref, b_ref = assert_matches_blink(o, d, t_far, pk, tris)
    hit = o[:, 0] < 5
    assert (p_ref[hit] >= 0).all() and (p_ref[~hit] == -1).all()
    ot, dt, tf = (torch.from_numpy(a) for a in (o, d, t_far))
    _, _, pops, tests = tp.ordered_walk_plain(ot, dt, pk, counts=True)
    assert (pops == 1).all() and torch.equal(tests, torch.from_numpy(np.where(hit, 16, 0)))
    blocked, pops, tests = tp.ordered_walk_plain(ot, dt, pk, t_far=tf, any_hit=True,
                                                 counts=True)
    live = hit & (t_far > 0)
    np.testing.assert_array_equal(blocked.numpy(), live)
    assert (pops == 1).all()
    np.testing.assert_array_equal(tests.numpy(), np.where(live, first + 1, 0))
    assert len(set(first[live].tolist())) > 1


def caterpillar(levels: int):
    """(vertices (T * 3, 3), FlatBVH): a tree `levels` internal nodes deep,
    in preorder. Internal node k has the leaf of triangle k (in the plane
    x = levels - k) on its left and internal node k + 1 (below the last, a
    leaf of 16 triangles just behind the plane x = 0, each 1/1024 behind the
    one before) on its right, so each of its levels nests one pending
    subtree. A ray along +x from x < 0 takes the right child first at every
    level and so pushes every leaf of the chain."""
    tri = [[[levels - k, -1, -1], [levels - k, 2, -1], [levels - k, -1, 2]]
           for k in range(levels)]
    tri += [[[-j / 1024, -1 + j / 8, -1], [-j / 1024, 1 + j / 8, -1], [-j / 1024, -1 + j / 8, 1]]
            for j in range(16)]
    tri = np.asarray(tri, np.float32)
    lo_t, hi_t = tri.min(1), tri.max(1)
    n = 2 * levels + 1
    lo, hi = np.zeros((n, 3), np.float32), np.zeros((n, 3), np.float32)
    skip, first, count = (np.zeros(n, np.int32) for _ in range(3))
    for k in range(levels):
        i = 2 * k  # internal node k, then the leaf of triangle k
        lo[i], hi[i] = lo_t[k:].min(0), hi_t[k:].max(0)
        skip[i] = n
        lo[i + 1], hi[i + 1] = lo_t[k], hi_t[k]
        skip[i + 1], first[i + 1], count[i + 1] = i + 2, k, 1
    lo[n - 1], hi[n - 1] = lo_t[levels:].min(0), hi_t[levels:].max(0)
    skip[n - 1], first[n - 1], count[n - 1] = n, levels, 16
    return tri.reshape(-1, 3), FlatBVH(
        lo=lo, hi=hi, skip=skip, first=first, count=count, tv0=tri[:, 0],
        te1=tri[:, 1] - tri[:, 0], te2=tri[:, 2] - tri[:, 0],
        tri_id=np.arange(tri.shape[0], dtype=np.int32), leaf_size=16)


def deep_case():
    """(blink Triangles, packed BVH at the deepest admitted depth, o, d,
    t_far): rays along +x from behind the chain (the bottom leaf first, with
    62 far leaves on the stack), along -x from in front (the top leaf
    first) and in random directions from inside the boxes."""
    levels = tp.STACK_CAP - 2
    verts, flat = caterpillar(levels)
    pk = tp.pack_bvh_planes(flat)
    with pytest.raises(ValueError, match="STACK_CAP"):
        tp.pack_bvh_planes(caterpillar(levels + 1)[1])
    rng = np.random.default_rng(83)
    n = 96
    o = np.zeros((n, 3), np.float32)
    d = np.zeros((n, 3), np.float32)
    o[:32] = [-1.0, 0.2, 0.1]
    d[:32, 0] = 1.0
    o[32:64] = [levels + 1.0, 0.2, 0.1]
    d[32:64, 0] = -1.0
    o[:64, 1:] += rng.uniform(-0.3, 0.3, (64, 2))
    o[64:] = rng.uniform([0, -0.5, -0.5], [levels, 0.5, 0.5], (32, 3))
    d[64:] = rng.standard_normal((32, 3))
    d[64:] /= np.linalg.norm(d[64:], axis=1, keepdims=True)
    t_far = np.full((n,), 2.0 * levels, np.float32)
    t_far[::3] = 0.5
    return blink_tris(verts, np.arange(verts.shape[0]).reshape(-1, 3)), pk, o, d, t_far


def test_deepest_admitted_tree():
    """At the depth `_check_depth` admits (one level more raises), rays
    along +x take the near child at each of the 62 levels and pop the far
    leaves back once they have hit the bottom; the walk matches blink's."""
    tris, pk, o, d, t_far = deep_case()
    p_ref, _ = assert_matches_blink(o, d, t_far, pk, tris)
    levels = tp.STACK_CAP - 2
    assert (p_ref[:32] >= levels).all() and (p_ref[32:64] == 0).all()
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    _, _, pops, tests = tp.ordered_walk_plain(ot, dt, pk, counts=True)
    # Behind the chain: every internal node and leaf once (the far leaves
    # are popped but fail their slab test against the bottom's hit).
    assert (pops[:32] == pk.n_nodes).all() and (tests[:32] == 16).all()
    # In front: the root, the top leaf (a hit at t = 1), the chain's next
    # internal node (culled).
    assert (pops[32:64] == 3).all() and (tests[32:64] == 1).all()


def test_trace_hook_sees_every_pop_and_test():
    """`_walk_chunk`'s trace (what binary_walk_ab.nested_model reads) is
    called once a step with the rays that stepped and their tests: summed,
    the counted pops and tests, for both walks and both kinds of hit."""
    _, pk, o, d, t_far = edge_case()
    ot, dt, tf = (torch.from_numpy(a) for a in (o, d, t_far))
    for ordered in (False, True):
        for any_hit in (False, True):
            pops = torch.zeros(N_RAYS, dtype=torch.int64)
            tests = torch.zeros_like(pops)
            seen_p, seen_t = torch.zeros_like(pops), torch.zeros_like(pops)

            def trace(act, read):
                seen_p.index_add_(0, act, torch.ones_like(act))
                seen_t.index_add_(0, act, read)

            bound = tf.clone() if any_hit else torch.full((N_RAYS,), tp.T_MAX)
            tp._walk_chunk(ot, dt, pk, bound, any_hit, tp.T_MIN, ordered, pops, tests,
                           trace=trace)
            assert torch.equal(seen_p, pops) and torch.equal(seen_t, tests)
            assert tests.sum() > 0


#: ordered_walk's ptxas report as the redesign leaves it: the stack in a
#: 256-byte frame and no spills.
@pytest.mark.parametrize("text, spills", [
    (ptxas_entry(ORD0, 256, 0, 0, 40) + ptxas_entry(ORD1, 256, 0, 0, 40),
     {ORD0: 0, ORD1: 0}),
    (ptxas_entry(SKIP0, 0, 0, 0, 56) + ptxas_entry(ORD1, 264, 8, 8, 64),
     {SKIP0: 0, ORD1: 16}),
], ids=["stack-no-spill", "stack-and-spill"])
def test_ptxas_spills_of_ordered_walk(text, spills):
    assert _build.ptxas_spills(text) == spills


def assert_kernels_match_plain(o, d, chunks, t_far):
    """ordered_walk<false/true> and their counting build against the plain
    walk, bit for bit, with the counting build's pops and tests ray for
    ray; closest hit with and without t_far."""
    n = o.shape[0]
    for far in (None, t_far):
        t_p, prim_p, v_p, q_p = tp.ordered_walk_plain(o, d, chunks, t_far=far, counts=True)
        t, prim = tp.traverse_closest_packed(o, d, chunks, t_far=far, variant="ordered")
        assert torch.equal(t, t_p) and torch.equal(prim, prim_p), (n, far is None)
        (t_c, prim_c), v, q, turns, lanes = tp.walk_counts("ordered_closest", o, d, chunks,
                                                          far)
        assert torch.equal(t_c, t_p) and torch.equal(prim_c, prim_p), n
        assert torch.equal(v, v_p) and torch.equal(q, q_p), n
        assert turns.shape == (-(-n // 32),) and (lanes <= 32 * turns).all()
    b_p, v_p, q_p = tp.ordered_walk_plain(o, d, chunks, t_far=t_far, any_hit=True, counts=True)
    assert torch.equal(tp.traverse_anyhit_packed(o, d, chunks, t_far, variant="ordered"), b_p)
    b_c, v, q, _, _ = tp.walk_counts("ordered_anyhit", o, d, chunks, t_far)
    assert torch.equal(b_c, b_p) and torch.equal(v, v_p) and torch.equal(q, q_p), n


@pytest.mark.gpu
def test_ordered_kernels_and_counting_build_match_plain_on_gpu():
    """On the edge case at 1, 31, 33, 97 and 333 rays (a partial last warp,
    coherent and random lanes in one warp, an all-dead warp from 97 on),
    the signed-zero pair, the root-leaf tree and the deepest admitted tree;
    rays blocked before a launch stay blocked."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, pk, o, d, t_far = edge_case()
    chunks = [pk.to("cuda")]
    for n in (1, 31, 33, 97, N_RAYS):
        assert_kernels_match_plain(*(torch.from_numpy(a[:n]).cuda() for a in (o, d)), chunks,
                                   torch.from_numpy(t_far[:n]).cuda())
    for case in (root_leaf_case()[1:5], deep_case()[1:]):
        assert_kernels_match_plain(*(torch.from_numpy(a).cuda() for a in case[1:3]),
                                   [case[0].to("cuda")], torch.from_numpy(case[3]).cuda())
    o0, d0 = torch.tensor(PAIR_O, device="cuda"), torch.tensor(PAIR_D, device="cuda")
    assert_kernels_match_plain(o0, d0, [pair_tree().to("cuda")],
                               torch.full((3,), 9.0, device="cuda"))
    pre = torch.zeros(N_RAYS, dtype=torch.bool, device="cuda")
    pre[::4] = True
    out = pre.clone()
    ot, dt, tf = (torch.from_numpy(a).cuda() for a in (o, d, t_far))
    tp._launch("ordered_anyhit", ot, dt, chunks[0], tf, out, tp.T_MIN)
    assert torch.equal(out, pre | tp.ordered_walk_plain(ot, dt, chunks, t_far=tf, any_hit=True))
