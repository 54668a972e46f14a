"""The wide walk's bookkeeping and dispatch against blink: the plain
walk's seen marks count one ray's distinct reads; BLINK_LEAF_MODE picks
the leaf schedule as blink's _default_leaf_mode does; row and stream on
chunks without row tables raise, or walk group under the variable. The
inputs are test_torch_wide_modes.py's.
"""
import numpy as np
import pytest
import torch

from blink_torch.kernels import traverse_wide as tw
from test_bvh import _random_tris
from test_torch_build import port_tris
from test_torch_wide_modes import blink_reference, shared_case


@pytest.fixture(scope="module")
def case():
    return {**shared_case(), **blink_reference()}


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
    raise too. SBVH chunks (spatial=True) build and walk to the same hits
    as the object-split chunks."""
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
    spatial = [tw.WideChunk.from_host(c, "cpu") for c in
               tw.build_chunked_wide(port_tris(tris), quant=True, row_tables=False,
                                     spatial=True)]
    t_s, prim_s = tw.traverse_closest_wide(o, d, spatial)
    assert torch.equal(t_s, t_g) and torch.equal(prim_s, prim_g)
