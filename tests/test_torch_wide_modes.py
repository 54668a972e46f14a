"""blink_torch's wide walk under every leaf schedule and child-box layout
against blink: the f32 and quantized tables with and without row tables,
the group, row, stream and skip plain walks, BLINK_LEAF_MODE's dispatch,
and a render through a Backend whose chunks carry row tables.

The plain walks must find blink's flat-BVH hits (prim exactly, t within
rtol/atol 1e-6, blocked flags exactly) and each other's bit for bit; skip
finds nothing. blink's own Pallas kernels are held to the same reference by
tests/test_pallas_interpret.py, so this file makes no interpret-mode call.
"""
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


@pytest.fixture(scope="module")
def case():
    tris = _random_tris(N_TRIS, 51)
    o, d = _random_rays(N_RAYS, 52)
    bvh = build_flat_bvh(tris)
    t_ref, p_ref = traverse_closest(o, d, bvh)
    t_far = np.full((N_RAYS,), T_FAR, np.float32)
    t_far[::4] = 0.0  # dead lanes
    b_ref = traverse_anyhit(o, d, bvh, t_far)
    chunks = {
        q: [tw.WideChunk.from_host(c, "cpu")
            for c in tw.build_chunked_wide(port_tris(tris), chunk_tris=CHUNK, quant=q)]
        for q in (False, True)
    }
    return {
        "tris": tris, "chunks": chunks,
        "o": torch.from_numpy(np.array(o)), "d": torch.from_numpy(np.array(d)),
        "t_far": torch.from_numpy(t_far), "t_ref": np.asarray(t_ref),
        "p_ref": np.asarray(p_ref), "b_ref": np.asarray(b_ref),
    }


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


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "quant"])
@pytest.mark.parametrize("mode", tw.LEAF_MODES)
def test_leaf_mode_walks_match_reference(case, quant, mode):
    """Each schedule's plain walk finds blink's hits and group's, bit for
    bit; skip finds none."""
    chunks, o, d, tf = case["chunks"][quant], case["o"], case["d"], case["t_far"]
    t, prim, pops, tests = tw.closest_wide_plain(o, d, chunks, counts=True, leaf_mode=mode)
    blocked, a_pops, a_tests = tw.anyhit_wide_plain(o, d, chunks, tf, counts=True,
                                                    leaf_mode=mode)
    assert (pops >= len(chunks)).all()
    if mode == "skip":
        assert (prim == -1).all() and (t == 1e30).all() and not blocked.any()
        assert (tests == 0).all() and (a_tests == 0).all()
        return
    assert (case["p_ref"] >= 0).sum() >= 5 and 0 < case["b_ref"].sum() < N_RAYS
    np.testing.assert_array_equal(prim.numpy(), case["p_ref"])
    np.testing.assert_allclose(t.numpy(), case["t_ref"], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(blocked.numpy(), case["b_ref"])
    t_g, prim_g, pops_g, tests_g = tw.closest_wide_plain(o, d, chunks, counts=True,
                                                         leaf_mode="group")
    assert torch.equal(t, t_g) and torch.equal(prim, prim_g)
    assert torch.equal(blocked, tw.anyhit_wide_plain(o, d, chunks, tf, leaf_mode="group"))
    if mode == "row":  # the same leaves, in the same order
        assert torch.equal(pops, pops_g) and torch.equal(tests, tests_g)
    else:  # stream prunes with a best t one leaf late
        assert (pops >= pops_g).all() and (tests >= tests_g).all()


@pytest.mark.parametrize("mode", ["group", "row"])
def test_seen_marks_count_one_rays_reads(case, mode):
    """For one ray, the marks are its distinct reads: every node popped
    and every slot (group) or batch (row) tested, once."""
    chunks = case["chunks"][True]
    hit = int(np.nonzero(case["p_ref"] >= 0)[0][0])
    o, d = case["o"][hit:hit + 1], case["d"][hit:hit + 1]
    seen = []
    _, prim, pops, tests = tw.closest_wide_plain(o, d, chunks, counts=True,
                                                 leaf_mode=mode, seen=seen)
    assert prim.item() == case["p_ref"][hit]
    assert sum(int(n.sum()) for n, _ in seen) == pops.item()
    leaf_rows = sum(int(s.sum()) for _, s in seen)
    assert leaf_rows == tests.item() if mode == "group" else 0 < leaf_rows <= tests.item()


@pytest.mark.parametrize(
    "env, tables, want",
    [("row", True, "row"), ("stream", True, "stream"), ("row", False, "group"),
     ("group", True, "group"), (None, True, "group"), ("fast", True, "group")],
)
def test_default_leaf_mode_honours_env(case, monkeypatch, env, tables, want):
    """BLINK_LEAF_MODE picks row or stream only for chunks with row tables
    (else blink's documented fallback to group); unset or unknown: group."""
    if env is None:
        monkeypatch.delenv("BLINK_LEAF_MODE", raising=False)
    else:
        monkeypatch.setenv("BLINK_LEAF_MODE", env)
    chunk = case["chunks"][True][0]
    if not tables:
        chunk = tw.WideChunk(chunk.child, chunk.nbox, chunk.perm, chunk.tri,
                             chunk.tri_id, chunk.max_stack)
    assert tw._default_leaf_mode(chunk) == want
    assert tw._default_leaf_mode(chunk, any_hit=True) == want


def test_modes_without_tables_raise(case, monkeypatch):
    """An explicit row or stream on chunks without row tables raises, as
    blink does; under BLINK_LEAF_MODE=row they walk group. Unknown modes
    and SBVH chunks raise too."""
    tris = _random_tris(300, 53)
    chunks = [tw.WideChunk.from_host(c, "cpu") for c in
              tw.build_chunked_wide(port_tris(tris), quant=True, row_tables=False)]
    o, d = case["o"], case["d"]
    for mode in ("row", "stream"):
        with pytest.raises(ValueError, match="row_tables"):
            tw.traverse_closest_wide(o, d, chunks, leaf_mode=mode)
        with pytest.raises(ValueError, match="row_tables"):
            tw.traverse_anyhit_wide(o, d, chunks, case["t_far"], leaf_mode=mode)
    with pytest.raises(ValueError, match="leaf_mode"):
        tw.traverse_closest_wide(o, d, chunks, leaf_mode="fast")
    monkeypatch.setenv("BLINK_LEAF_MODE", "row")
    t, prim = tw.traverse_closest_wide(o, d, chunks)
    t_g, prim_g = tw.traverse_closest_wide(o, d, chunks, leaf_mode="group")
    assert torch.equal(t, t_g) and torch.equal(prim, prim_g)
    with pytest.raises(NotImplementedError):
        tw.build_chunked_wide(port_tris(tris), spatial=True)


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


@pytest.mark.gpu
def test_wide_variants_match_plain_on_gpu(case):
    """Every kernel variant (closest and any hit, f32 and quantized boxes,
    the four leaf schedules) against its plain version on the card, bit
    for bit, one launch per chunk under its own LAUNCHES name."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    o, d, tf = case["o"].cuda(), case["d"].cuda(), case["t_far"].cuda()
    for quant in (False, True):
        chunks = [tw.WideChunk.from_host(c, "cuda") for c in tw.build_chunked_wide(
            port_tris(case["tris"]), chunk_tris=CHUNK, quant=quant)]
        for mode in tw.LEAF_MODES:
            before = dict(tw.LAUNCHES)
            t, prim = tw.traverse_closest_wide(o, d, chunks, leaf_mode=mode)
            t_p, prim_p = tw.closest_wide_plain(o, d, chunks, leaf_mode=mode)
            assert torch.equal(t, t_p) and torch.equal(prim, prim_p), (quant, mode)
            blocked = tw.traverse_anyhit_wide(o, d, chunks, tf, leaf_mode=mode)
            assert torch.equal(blocked, tw.anyhit_wide_plain(o, d, chunks, tf,
                                                             leaf_mode=mode)), (quant, mode)
            for any_hit in (False, True):
                name = tw.launch_name(any_hit, mode, quant)
                assert tw.LAUNCHES[name] - before[name] == len(chunks), name
