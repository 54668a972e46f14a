"""The stream walk's late hit: rays whose only hit lies in the leaf still
pending when the stream walk ends (test_torch_row_stream_walk.late_hit_case)
find it in the last call of the leaf tests, closest and any hit alike, and
every plain walk of the case finds blink's flat-BVH hits.
"""
import pytest
import torch

from blink_torch.kernels import traverse_wide as tw
from test_torch_row_stream_walk import N_LATE, N_SLIVERS, assert_blink_hits, late_hit_case


@pytest.mark.parametrize("quant", [True, False], ids=["quant", "f32"])
def test_stream_finds_a_hit_in_the_leaf_pending_at_the_end(quant, monkeypatch):
    """Each late-hit ray reaches several leaves, and the stream walk finds
    its one hit only in the test of the pending leaf after the walk: the
    last call of the leaf tests, for closest and any hit alike."""
    _, host, o, d, t_far = late_hit_case(quant)
    p_ref, b_ref = assert_blink_hits(late_hit_case, quant, "stream")
    assert (p_ref == N_SLIVERS).all() and b_ref.all()
    chunks = [tw.WideChunk.from_host(c, "cpu") for c in host]
    leaf_tests = tw._leaf_tests
    for any_hit in (False, True):
        for r in range(N_LATE):
            got = []

            def recorded(*args, **kw):
                out = leaf_tests(*args, **kw)
                got.append(bool(out[0].any()))
                return out

            monkeypatch.setattr(tw, "_leaf_tests", recorded)
            ot, dt = torch.from_numpy(o[r:r + 1]), torch.from_numpy(d[r:r + 1])
            if any_hit:
                *_, tests = tw.anyhit_wide_plain(ot, dt, chunks, torch.from_numpy(
                    t_far[r:r + 1]), counts=True, leaf_mode="stream")
            else:
                *_, tests = tw.closest_wide_plain(ot, dt, chunks, counts=True,
                                                  leaf_mode="stream")
            monkeypatch.setattr(tw, "_leaf_tests", leaf_tests)
            assert len(got) >= 3 and got[-1] and not any(got[:-1]), (any_hit, r, got)
            assert int(tests[0]) >= N_SLIVERS, (any_hit, r)
