"""raybench/lib/spans.py on a synthetic Chrome trace: a kernel belongs to the
innermost blink.* range open on its launching thread at its launch call;
a stage's device time is divided by the stretch's steps; a range that never
opened reads None; the live share sums every walk counter."""
import types

import pytest

from raybench.lib import bench, spans
from raybench.lib.trace import STEP_SPAN, Profile

MAIN, AUTOGRAD = 11, 22


def _range(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def _kernel(corr, launch_ts, dur, tid=MAIN, name="k"):
    """A runtime launch call on `tid` at launch_ts, and its kernel on the
    device a little later."""
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch_ts,
             "dur": 1, "tid": tid, "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": name, "ts": launch_ts + 5, "dur": dur,
             "tid": 7, "args": {"correlation": corr}}]


def _ctx(events):
    return types.SimpleNamespace(profile=Profile(events))


def _two_steps():
    """Two steps; in each, blink.render holds blink.camera (with a
    blink.sampler inside) and blink.nee (with blink.shadow inside); the
    backward's scatter range opens on another thread."""
    ev = []
    corr = 0
    for step, t0 in enumerate((0.0, 1000.0)):
        ev.append(_range(STEP_SPAN, t0, 900))
        ev.append(_range("blink.render", t0 + 10, 500))
        ev.append(_range("blink.camera", t0 + 20, 100))
        ev.append(_range("blink.sampler", t0 + 30, 20))
        ev.append(_range("blink.nee", t0 + 200, 200))
        ev.append(_range("blink.shadow", t0 + 250, 50))
        ev.append(_range("blink.backward", t0 + 600, 200))
        ev.append(_range("blink.scatter_tri_verts", t0 + 650, 40, tid=AUTOGRAD))
        for ts, dur, tid in ((t0 + 35, 8.0, MAIN),     # sampler, inside camera
                             (t0 + 60, 4.0, MAIN),     # camera itself
                             (t0 + 210, 6.0, MAIN),    # nee itself
                             (t0 + 260, 30.0, MAIN),   # shadow, inside nee
                             (t0 + 350, 2.0, MAIN),    # nee after the shadow walk
                             (t0 + 450, 1.0, MAIN),    # render alone
                             (t0 + 36, 50.0, AUTOGRAD),  # another thread, no range open
                             (t0 + 660, 12.0, AUTOGRAD),  # the scatter
                             (t0 + 610, 3.0, MAIN)):   # backward on the main thread
            corr += 1
            ev += _kernel(corr, ts, dur, tid)
    return ev


def test_a_kernel_goes_to_the_innermost_range_of_its_thread():
    ctx = _ctx(_two_steps())
    by, opened = spans.attribute(ctx.profile)
    assert opened == {"render", "camera", "sampler", "nee", "shadow", "backward",
                      "scatter_tri_verts"}
    us = {k: v * 1e6 for k, v in by.items()}
    assert us == pytest.approx({"sampler": 16, "camera": 8, "nee": 16, "shadow": 60,
                                "render": 2, None: 100, "scatter_tri_verts": 24,
                                "backward": 6})


def test_stage_ms_is_per_step_and_none_where_no_range_opened():
    ctx = _ctx(_two_steps())
    assert ctx.profile.n_steps == 2
    assert spans.stage_ms(ctx, "sampler") == pytest.approx(8e-3)
    assert spans.stage_ms(ctx, "camera") == pytest.approx(4e-3)
    assert spans.stage_ms(ctx, "nee") == pytest.approx(8e-3)
    assert spans.stage_ms(ctx, "scatter_tri_verts") == pytest.approx(12e-3)
    assert spans.stage_ms(ctx, "compact") is None
    assert spans.stage_ms(types.SimpleNamespace(profile=None), "nee") is None


def test_a_kernel_of_another_thread_goes_to_no_forward_stage():
    """The 50 µs kernel launched on the autograd thread while the main
    thread is inside blink.sampler counts to no stage."""
    ev = _two_steps()
    ctx = _ctx(ev)
    without = _ctx([e for e in ev if not (e.get("args", {}).get("correlation") in (7, 16))])
    for stage in ("sampler", "camera", "render", "nee"):
        assert spans.stage_ms(ctx, stage) == spans.stage_ms(without, stage)
    assert spans.attribute(ctx.profile)[0][None] == pytest.approx(100e-6)


def test_ranges_that_share_a_start_nest_longest_first():
    ev = [_range(STEP_SPAN, 0, 100), _range("blink.nee", 10, 50), _range("blink.shadow", 10, 20),
          _range("blink.sampler", 31, 5)]
    ev += _kernel(1, 15, 3.0) + _kernel(2, 40, 5.0) + _kernel(3, 32, 7.0) + _kernel(4, 70, 1.0)
    by, _ = spans.attribute(_ctx(ev).profile)
    assert {k: v * 1e6 for k, v in by.items()} == pytest.approx(
        {"shadow": 3, "nee": 5, "sampler": 7, None: 1})


def test_live_share_sums_every_walk():
    assert spans.live_share({"walk_lanes.closest": 300, "walk_live.closest": 150,
                             "walk_lanes.anyhit": 100, "walk_live.anyhit": 50}) == 50.0
    assert spans.live_share({}) is None


def test_walk_live_share_reads_the_program_counters():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from blink_torch.obs import profile as bp

    bp.reset_counts()
    try:
        assert spans.walk_live_share() is None
        with profile(activities=[ProfilerActivity.CPU]):
            bp.count("walk_lanes.closest", 8)
            bp.count("walk_live.closest", torch.tensor([1, 0, 1, 1]).sum())
        assert spans.walk_live_share() == 37.5
    finally:
        bp.reset_counts()


def test_every_stage_metric_of_a_cell_reads_none_without_a_trace(root, cell):
    from blink_torch.obs import profile as bp

    bp.reset_counts()
    spec = bench.cell_spec(root, cell)
    names = [m["name"] for m in spec.metrics(True)
             if m["source"] in ("program_span", "program_counter")]
    assert any(n.startswith("walk_live_share.") for n in names), names
    for n in names:
        assert bench.load_reader(root, n)(types.SimpleNamespace(profile=None)) is None, n
