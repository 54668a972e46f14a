"""blink_torch's wide tables under every child-box layout against blink:
the f32 and quantized tables with and without row tables, split_free and
unpadded chunks, a hand-built chunk's box layout, and a render through a
Backend whose chunks carry row tables.

The shared inputs live here (shared_case, blink_reference) and are imported
by name by test_torch_wide_leaf_modes.py (each leaf schedule's plain walk
against blink's flat-BVH hits) and test_torch_wide_dispatch.py (seen marks,
BLINK_LEAF_MODE's dispatch). blink's own Pallas kernels are held to the same
reference by tests/test_pallas_interpret.py, so these files make no
interpret-mode call.
"""
import functools

import numpy as np
import pytest
import torch

from blink.bvh import build_flat_bvh
from blink.kernels.traverse import traverse_anyhit, traverse_closest
from blink.kernels.traverse_pallas import build_chunked_wide as jax_build_chunked_wide
from blink_torch.api import render
from blink_torch.config import get_config
from blink_torch.kernels import traverse_wide as tw
from blink_torch.kernels.api import Backend
from blink_torch.scene import builders
from blink_torch.scene.shade import pack_tri_shade_np
from test_bvh import _random_rays, _random_tris
from test_torch_build import port_tris

N_TRIS, N_RAYS, CHUNK = 1400, 220, 700
T_FAR = 5.0


def tbat_as_blink(tbat: np.ndarray) -> np.ndarray:
    """The port's batch-major (n, 8, 16) table in blink's (n, 128) tiles:
    batch B at rows 8*(B//8), lanes 16*(B%8)."""
    n = tbat.shape[0]
    return tbat.reshape(n // 8, 8, 8, 16).transpose(0, 2, 1, 3).reshape(n, 128)


def assert_tables_equal(ref_chunks, port_chunks, quant: bool, row_tables: bool) -> None:
    assert len(ref_chunks) == len(port_chunks)
    for r, p in zip(ref_chunks, port_chunks):
        assert (p.quant, p.leaf_size, p.block_reads) == (r.quant, r.leaf_size, r.block_reads)
        assert p.quant == quant and p.n_wide == r.n_wide and p.max_stack == r.max_stack
        assert p.child.dtype == (np.int32 if quant else np.float32)
        np.testing.assert_array_equal(p.child, np.asarray(r.child))
        np.testing.assert_array_equal(p.perm, np.asarray(r.perm))
        if quant:
            np.testing.assert_array_equal(p.nbox, np.asarray(r.nbox))
        else:
            assert p.nbox is None and r.nbox is None
        rec = np.asarray(r.trow)[:, :120].reshape(-1, 10)
        np.testing.assert_array_equal(p.tri[:, :9], rec[:, :9])
        np.testing.assert_array_equal(p.tri_id, rec[:, 9].astype(np.int32))
        if row_tables:
            np.testing.assert_array_equal(p.bref, np.asarray(r.bref))
            np.testing.assert_array_equal(tbat_as_blink(p.tbat), np.asarray(r.tbat))
        else:
            assert p.bref is None and p.tbat is None and r.bref is None


def leaf_children(chunks) -> int:
    n = 0
    for c in chunks:
        cnt = c.child.reshape(-1, 3)[:, 0] >> 24 if c.quant else c.child.reshape(-1, 8)[:, 7]
        n += int((cnt > 0).sum())
    return n


@functools.lru_cache(maxsize=None)
def shared_case() -> dict:
    """N_TRIS random triangles, their chunks with f32 and quantized boxes,
    N_RAYS random rays and t_far (every fourth lane dead). Built once a
    process; no test changes it."""
    tris = _random_tris(N_TRIS, 51)
    o, d = _random_rays(N_RAYS, 52)
    t_far = np.full((N_RAYS,), T_FAR, np.float32)
    t_far[::4] = 0.0  # dead lanes
    chunks = {
        q: [tw.WideChunk.from_host(c, "cpu")
            for c in tw.build_chunked_wide(port_tris(tris), chunk_tris=CHUNK, quant=q)]
        for q in (False, True)
    }
    return {
        "tris": tris, "chunks": chunks, "o_np": np.array(o), "d_np": np.array(d),
        "o": torch.from_numpy(np.array(o)), "d": torch.from_numpy(np.array(d)),
        "t_far": torch.from_numpy(t_far),
    }


@functools.lru_cache(maxsize=None)
def blink_reference() -> dict:
    """blink's flat-BVH hits on shared_case: t_ref, p_ref and b_ref (one
    compile of blink's walks a process)."""
    c = shared_case()
    bvh = build_flat_bvh(c["tris"])
    t_ref, p_ref = traverse_closest(c["o_np"], c["d_np"], bvh)
    b_ref = traverse_anyhit(c["o_np"], c["d_np"], bvh, c["t_far"].numpy())
    return {"t_ref": np.asarray(t_ref), "p_ref": np.asarray(p_ref), "b_ref": np.asarray(b_ref)}


@pytest.fixture(scope="module")
def case():
    return shared_case()


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("row_tables", [False, True])
def test_chunked_tables_match_reference(case, quant, row_tables):
    """Two chunks padded to one shape, array for array."""
    ref = jax_build_chunked_wide(case["tris"], chunk_tris=CHUNK, quant=quant,
                                 row_tables=row_tables)
    port = tw.build_chunked_wide(port_tris(case["tris"]), chunk_tris=CHUNK, quant=quant,
                                 row_tables=row_tables)
    assert len(port) == 2 and port[0].n_wide == port[1].n_wide
    assert_tables_equal(ref, port, quant, row_tables)


@pytest.mark.parametrize("quant", [False, True])
def test_unpadded_split_free_tables_match_reference(case, quant):
    """build_wide's other knobs: split_free, block_reads, another wide
    leaf, chunks left unpadded (uniform=False)."""
    kw = dict(chunk_tris=CHUNK, wide_leaf=16, split_free=True, block_reads=True,
              uniform=False, quant=quant)
    ref = jax_build_chunked_wide(case["tris"], **kw)
    port = tw.build_chunked_wide(port_tris(case["tris"]), **kw)
    assert port[0].n_wide != port[1].n_wide or port[0].tbat.shape != port[1].tbat.shape
    assert_tables_equal(ref, port, quant, True)
    plain = tw.build_chunked_wide(port_tris(case["tris"]), chunk_tris=CHUNK, wide_leaf=16,
                                  uniform=False, quant=quant)
    assert leaf_children(port) > leaf_children(plain)  # finer leaves in free slots


@pytest.mark.parametrize("quant", [False, True])
def test_hand_built_chunk_reads_its_box_layout(case, quant):
    """A WideChunk built field by field, without the host WideBVH, takes
    its box layout from its child table's type and walks as the chunk
    from_host made."""
    made = case["chunks"][quant]
    hand = [tw.WideChunk(c.child, c.nbox, c.perm, c.tri, c.tri_id, c.max_stack) for c in made]
    assert all(h.quant == quant for h in hand)
    o, d = case["o"], case["d"]
    t, prim = tw.closest_wide_plain(o, d, hand)
    t_m, prim_m = tw.closest_wide_plain(o, d, made)
    assert torch.equal(t, t_m) and torch.equal(prim, prim_m)


def test_render_through_row_table_backend(monkeypatch):
    """Cornell at 32x32 through a wide Backend whose chunks carry row
    tables: BLINK_LEAF_MODE=row and stream reach the walks and give
    group's image."""
    cfg = get_config("cornell").override(width=32, height=32, deterministic=True)
    scene = builders.cornell_box()
    chunks = tw.build_chunked_wide(scene.triangles)
    assert len(chunks) == 1 and chunks[0].tbat is not None and not chunks[0].quant
    backend = Backend(name="wide", chunks=[tw.WideChunk.from_host(c, "cpu") for c in chunks],
                      shade=torch.as_tensor(pack_tri_shade_np(scene.triangles)))
    modes = []
    walk = tw._walk_plain

    def spy(*args, **kwargs):
        modes.append(args[6])
        return walk(*args, **kwargs)

    monkeypatch.setattr(tw, "_walk_plain", spy)
    images = {}
    for mode in ("group", "row", "stream"):
        monkeypatch.setenv("BLINK_LEAF_MODE", mode)
        modes.clear()
        images[mode] = render(scene, cfg, device="cpu", backend=backend)
        assert modes and set(modes) == {mode}, (mode, set(modes))
    assert images["group"].abs().sum() > 0
    assert torch.equal(images["row"], images["group"])
    assert torch.equal(images["stream"], images["group"])
