"""blink_torch's wide walk under every leaf schedule against blink: the
group, row, stream and skip plain walks over f32 and quantized chunks
must find blink's flat-BVH hits (prim exactly, t within rtol/atol 1e-6,
blocked flags exactly) and each other's bit for bit; skip finds nothing.
On the card (gpu marker), every kernel variant against its plain version.
The inputs are test_torch_wide_modes.py's.
"""
import numpy as np
import pytest
import torch

from blink_torch.kernels import traverse_wide as tw
from test_torch_build import port_tris
from test_torch_wide_modes import CHUNK, N_RAYS, blink_reference, shared_case


@pytest.fixture(scope="module")
def case():
    return {**shared_case(), **blink_reference()}


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
