"""The production wide walk (leaf_mode='group') at its edges, and the
layout facts its CUDA kernel (csrc/wide_walk.cu::wide_group_walk) reads.

On the CPU: every build_chunked_wide layout keeps each leaf child's
triangle span inside the record table (the kernel loads a leaf's records
in batches, each load predicated on the leaf's end, so it reads nothing
past that span) and a node's child records at a 16-byte stride; the
plain walks find blink's flat-BVH hits on the edge cases below; the
parser of ptxas's spill report. On the card (gpu
marker): the kernels against the plain walks, bit for bit, on the same
edge cases: ray counts of 1 and not a multiple of 32 or 128, t_far = 0
lanes, direction components exactly 0, rays blocked before the call,
leaves of wide_leaf = 44 triangles and two coincident triangles (the
kernel must pick the plain walk's winner of the exact tie).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blink.bvh import build_flat_bvh
from blink.kernels.traverse import traverse_anyhit, traverse_closest
from blink_torch.kernels import _build
from blink_torch.kernels import traverse_wide as tw
from blink_torch.kernels.types import T_MIN
from test_bvh import _random_rays, _random_tris
from test_torch_build import port_tris

N_TRIS, CHUNK, WIDE_LEAF = 3000, 1500, 44
N_RAYS = 333  # not a multiple of 32 or of the kernel's 128-thread block


def leaf_spans(c):
    """(ref, cnt) of every leaf child of a host WideBVH."""
    if c.quant:
        w = c.child.reshape(-1, 3)
        ref, cnt = w[:, 2].astype(np.int64), (w[:, 0] >> 24).astype(np.int64)
    else:
        w = c.child.reshape(-1, 8)
        ref, cnt = w[:, 6].astype(np.int64), w[:, 7].astype(np.int64)
    leaf = cnt > 0
    return ref[leaf], cnt[leaf]


@pytest.mark.parametrize("quant", [True, False], ids=["quant", "f32"])
@pytest.mark.parametrize("wide_leaf", [4, 32, 44])
def test_record_table_covers_every_leaf_span(quant, wide_leaf):
    tris = port_tris(_random_tris(2000, 7))
    chunks = tw.build_chunked_wide(tris, chunk_tris=700, wide_leaf=wide_leaf, quant=quant,
                                   row_tables=False)
    assert len(chunks) == 3
    for c in chunks:
        ref, cnt = leaf_spans(c)
        assert cnt.max() <= wide_leaf and ref.min() >= 0
        # Every leaf span lies inside the record table, on real records.
        end = int((ref + cnt).max())
        assert end <= c.tri.shape[0] and (c.tri_id[:end] >= 0).all()
        # A node's child records, read as 16-byte loads, lie at a stride of
        # a multiple of 16 bytes: 96 quantized, 256 with f32 boxes.
        assert c.child.nbytes == c.n_wide * (96 if quant else 256)


def edge_case(quant: bool):
    """Random triangles with triangle N-2 made a copy of N-1, two chunks
    with leaves of up to 44; rays: random ones with exact zero direction
    components (one, two) and ones aimed at the coincident pair."""
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
                                 quant=quant, row_tables=False)
    t_far = np.full((N_RAYS,), 6.0, np.float32)
    t_far[::5] = 0.0
    return tris, host, o.astype(np.float32), d.astype(np.float32), t_far


@pytest.mark.parametrize("quant", [True, False], ids=["quant", "f32"])
def test_group_plain_walks_match_reference_at_the_edges(quant):
    tris, host, o, d, t_far = edge_case(quant)
    assert len(host) == 2 and max(int(leaf_spans(c)[1].max()) for c in host) == WIDE_LEAF
    chunks = [tw.WideChunk.from_host(c, "cpu") for c in host]
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    bvh = build_flat_bvh(tris)
    t_ref, p_ref = (np.asarray(a) for a in traverse_closest(o, d, bvh))
    t, prim = tw.closest_wide_plain(ot, dt, chunks, leaf_mode="group")
    pair = {N_TRIS - 2, N_TRIS - 1}
    tied = np.isin(p_ref, list(pair))
    assert tied.sum() >= 8 and set(prim.numpy()[tied]) <= pair  # rays reach the pair
    np.testing.assert_array_equal(prim.numpy()[~tied], p_ref[~tied])
    np.testing.assert_allclose(t.numpy(), t_ref, rtol=1e-6, atol=1e-6)
    b_ref = np.asarray(traverse_anyhit(o, d, bvh, t_far))
    blocked = tw.anyhit_wide_plain(ot, dt, chunks, torch.from_numpy(t_far), leaf_mode="group")
    assert 0 < b_ref.sum() < N_RAYS and not b_ref[::5].any()
    np.testing.assert_array_equal(blocked.numpy(), b_ref)


ENTRY = "_ZN12_GLOBAL__N_115wide_group_walkILb1ELb1EEEvPKfS2_PfPiPbPKvS2_PKiPK6float4S8_if"


def ptxas_entry(name, stack, stores, loads, regs):
    return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    {stack} bytes stack frame, {stores} bytes spill stores, {loads} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, used 0 barriers, {stack} bytes cumulative "
            f"stack size\n")


@pytest.mark.parametrize("text, spills", [
    # a template kernel in an anonymous namespace, with spills
    (ptxas_entry(ENTRY, 768, 8, 12, 72), {ENTRY: 20}),
    # two entries, one of them an extern "C" name, and nvcc's other lines
    ("ptxas info    : 0 bytes gmem\n" + ptxas_entry("sphere_pass", 0, 0, 0, 29)
     + "ptxas info    : Compile time = 12.300 ms\n" + ptxas_entry(ENTRY, 768, 0, 0, 127),
     {"sphere_pass": 0, ENTRY: 0}),
    # a device function reported on its own is not a kernel
    ("ptxas info    : Function properties for _Z3fooi\n"
     "    16 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
     + ptxas_entry(ENTRY, 768, 0, 0, 127), {ENTRY: 0}),
    # nvcc's name for an anonymous namespace in a whole-program build
    (ptxas_entry("_ZN34_INTERNAL_0a1b2c3d_12_wide_walk_cu15wide_group_walkILb0ELb1EEEvPKf",
                 768, 0, 4, 128),
     {"_ZN34_INTERNAL_0a1b2c3d_12_wide_walk_cu15wide_group_walkILb0ELb1EEEvPKf": 4}),
    ("", {}),
], ids=["spills", "two-entries", "device-function", "internal-namespace", "empty"])
def test_ptxas_spills_by_kernel(text, spills):
    assert _build.ptxas_spills(text) == spills


@pytest.mark.gpu
def test_group_kernels_match_plain_at_the_edges_on_gpu():
    """wide_group_walk, closest and any hit, quantized and f32 boxes,
    against the plain walks bit for bit on the edge cases, at 1, 97 and
    333 rays; and rays blocked before a launch stay blocked and do no
    work."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for quant in (True, False):
        _, host, o, d, t_far = edge_case(quant)
        chunks = [tw.WideChunk.from_host(c, "cuda") for c in host]
        for n in (1, 97, N_RAYS):
            ot, dt = torch.from_numpy(o[-n:]).cuda(), torch.from_numpy(d[-n:]).cuda()
            tf = torch.from_numpy(t_far[-n:]).cuda()
            for far in (None, tf):
                t, prim = tw.traverse_closest_wide(ot, dt, chunks, t_far=far, leaf_mode="group")
                t_p, prim_p = tw.closest_wide_plain(ot, dt, chunks, t_far=far, leaf_mode="group")
                assert torch.equal(t, t_p) and torch.equal(prim, prim_p), (quant, n, far is None)
            blocked = tw.traverse_anyhit_wide(ot, dt, chunks, tf, leaf_mode="group")
            ref = tw.anyhit_wide_plain(ot, dt, chunks, tf, leaf_mode="group")
            assert torch.equal(blocked, ref), (quant, n)
        pre = torch.zeros(N_RAYS, dtype=torch.bool, device="cuda")
        pre[::4] = True
        out = pre.clone()
        ot, dt, tf = (torch.from_numpy(a).cuda() for a in (o, d, t_far))
        for c in chunks:
            tw._launch(True, "group", ot, dt, c, tf, out, T_MIN)
        assert torch.equal(out, pre | tw.anyhit_wide_plain(ot, dt, chunks, tf, leaf_mode="group"))
