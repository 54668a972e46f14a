"""Rates and tails over all steps of a window, the trace's arithmetic (idle
share, device time by layer, launches) and the walk's counted work and
roofline."""
import time

import numpy as np
import pytest
import torch

from raybench.lib import bench, layers, walkcount
from raybench.lib.trace import Profile, gaps, union_s


def _ctx(step_s, work=1000):
    return bench.Context("render_grad", 1.0, 0.5, list(step_s), float(sum(step_s)), work)


def test_rate_and_tail_take_every_step():
    calm = [0.010] * 100
    stalled = [0.010] * 90 + [0.200] * 10  # a slow spell of ten steps
    one = [0.010] * 99 + [2.0]  # one long stall
    assert layers.rate(_ctx(calm)) == pytest.approx(100 * 1000 / 1.0)
    assert layers.rate(_ctx(stalled)) < 0.4 * layers.rate(_ctx(calm))
    assert layers.rate(_ctx(one)) < 0.4 * layers.rate(_ctx(calm))
    assert layers.p95_ms(_ctx(calm)) == pytest.approx(10.0)
    assert layers.p95_ms(_ctx(stalled)) > 100.0
    assert layers.p95_ms(_ctx(stalled)) == pytest.approx(
        np.percentile(np.asarray(stalled) * 1e3, 95))


#: A stall's steps' pause, in s: longer than a tiny cell's step on the CPU
#: (a `path` frame there takes about 0.9 s).
PAUSE_S = 2.0


@pytest.mark.parametrize("workload", ["sponza1m.grad", "sponza1m.path", "sponza1m.frame"])
def test_window_loop_counts_a_stall(tiny_cell, monkeypatch, workload):
    """The harness's own window: a stall of a few steps inside it lowers
    every rate and lifts every tail of the cell's end-to-end metrics (one
    cell of each end-to-end metric but setup_s)."""
    spec = tiny_cell(workload)
    spec.traffic["render"].update(width=16, height=16)
    if spec.traffic["kind"] == "render":
        spec.traffic["render"].update(spp=2, spp_block=2, max_depth=2)
    spec.traffic["check"]["steps"] = 1
    base = bench.run_cell(spec, 11, 1.5 * PAUSE_S, False, "cpu", time.perf_counter())
    orig = bench.Program.step
    calls = {"n": 0}

    def slow(self, sseed):
        calls["n"] += 1
        if 2 <= calls["n"] - spec.traffic["warmup_steps"] < 5:
            time.sleep(PAUSE_S)
        return orig(self, sseed)

    monkeypatch.setattr(bench.Program, "step", slow)
    hit = bench.run_cell(spec, 11, 1.5 * PAUSE_S, False, "cpu", time.perf_counter())
    m0, m1 = base["metrics"], hit["metrics"]
    moved = [m for m in spec.metrics(False) if m["name"] != "setup_s"]
    assert moved
    for m in moved:
        v0, v1 = m0[m["name"]]["value"], m1[m["name"]]["value"]
        if m["better"] == "higher":
            assert v1 < 0.8 * v0, m["name"]
        else:
            assert v1 > 900.0 * PAUSE_S > v0, m["name"]


def _trace():
    """Two steps of 10 ms each (µs): kernels, a walk, a scatter kernel
    launched under aten::index_add_ and another backward kernel, each inside
    a range of autograd's engine on its own thread, a copy, and host ops."""
    ev = []

    def x(cat, name, ts, dur, tid=1, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
                   "pid": 1, "args": args})

    for s, t0 in enumerate((1000.0, 11000.0)):
        x("user_annotation", "raybench.step", t0, 10000.0)
        c = 100 * s
        x("cpu_op", "aten::mul", t0 + 100, 50)
        x("cuda_runtime", "cudaLaunchKernel", t0 + 110, 5, correlation=c + 1)
        x("kernel", "elementwise_mul", t0 + 200, 1000, tid=7, correlation=c + 1)
        x("cuda_runtime", "cudaLaunchKernel", t0 + 300, 5, correlation=c + 2)
        x("kernel", "void wide_group_walk<false, true, 0>", t0 + 1500, 2000, tid=7,
          correlation=c + 2)
        x("cpu_op", "autograd::engine::evaluate_function: IndexSelectBackward0", t0 + 380,
          200, tid=2)
        x("cpu_op", "aten::index_add_", t0 + 400, 100, tid=2)
        x("cuda_runtime", "cudaLaunchKernel", t0 + 450, 5, tid=2, correlation=c + 3)
        x("kernel", "indexFuncLargeIndex", t0 + 4000, 3000, tid=7, correlation=c + 3)
        x("gpu_memcpy", "Memcpy DtoH", t0 + 7500, 500, tid=7)
        x("cpu_op", "autograd::engine::evaluate_function: MulBackward0", t0 + 600, 100, tid=2)
        x("cuda_runtime", "cudaLaunchKernel", t0 + 650, 5, tid=2, correlation=c + 4)
        x("kernel", "elementwise_mul_backward", t0 + 8000, 500, tid=7, correlation=c + 4)
    x("kernel", "outside_the_window", 30000.0, 100, tid=7, correlation=999)
    return Profile(ev)


def test_trace_arithmetic():
    p = _trace()
    assert p.n_steps == 2 and (p.hi - p.lo) * 1e-6 == pytest.approx(0.020)
    assert len(p.kernels) == 8
    # busy: per step 1000 + 2000 + 3000 + 500 + 500 µs, no overlap.
    assert Profile.busy_of(p.device) == pytest.approx(2 * 7000e-6)
    ctx = _ctx([0.01, 0.01])
    ctx.profile = p
    assert layers.idle_share(ctx) is None  # read from the device-only stretch
    ctx.busy_s, ctx.window_s_traced = Profile.busy_of(p.device), 0.020
    assert layers.idle_share(ctx) == pytest.approx(100 * (1 - 14000 / 20000))
    assert layers.launches(ctx) == 4
    assert layers.walk_ms(ctx) == pytest.approx(2.0)
    assert layers.scatter_ms(ctx) == pytest.approx(3.0)
    assert layers.integrator_ms(ctx) == pytest.approx(1.0)
    assert layers.backward_ms(ctx) == pytest.approx(0.5)
    ops = dict(p.device_ops())
    assert ops["indexFuncLargeIndex"] == pytest.approx(0.006)
    idle = dict(p.idle_gaps())
    assert sum(idle.values()) == pytest.approx(0.020 - 0.014)
    ctx.walk_work = {"pops": 1e9, "tests": 2e9, "live_rays": 1e6}
    bound, kind = walkcount.bound_s(ctx.walk_work)
    assert kind == "operations"
    assert bound == pytest.approx((160 * 1e9 + 35 * 2e9) / 67e12)
    assert layers.walk_roofline(ctx) == pytest.approx(100 * bound / 0.002)
    ctx.walk_work = {"pops": 1.0, "tests": 1.0, "live_rays": 1e9}
    assert walkcount.bound_s(ctx.walk_work) == (pytest.approx(32e9 / 3.35e12), "bytes")


def test_no_trace_reads_nothing():
    ctx = _ctx([0.01])
    for f in (layers.idle_share, layers.launches, layers.walk_ms, layers.scatter_ms,
              layers.integrator_ms, layers.backward_ms, layers.walk_roofline, layers.p95_ms_untraced):
        assert f(ctx) is None
    ctx.profile = Profile([])
    assert layers.idle_share(ctx) is None and layers.walk_roofline(ctx) is None


def test_union_and_gaps():
    iv = [(0, 10), (5, 20), (30, 40)]
    assert union_s(iv, 0, 50) == pytest.approx(30e-6)
    assert union_s(iv, 8, 35) == pytest.approx(17e-6)
    assert gaps(iv, 0, 50) == [(20, 30), (40, 50)]


def test_walk_counts_match_the_port_plain_walk():
    """The frozen counting copy counts what the program's plain walk counts,
    on both walks, over several chunks."""
    from blink_torch.kernels.traverse_wide import (anyhit_wide_plain, build_chunked_wide,
                                                   closest_wide_plain, WideChunk)
    from blink_torch.scene.scene import scene_from_numpy

    from raybench.lib import scenes

    s = scene_from_numpy(scenes.sponza(6000))
    chunks = [WideChunk.from_host(c, "cpu") for c in build_chunked_wide(
        s.triangles, chunk_tris=2500, wide_leaf=44, quant=True, row_tables=False,
        order_from=s.camera.origin.numpy())]
    g = torch.Generator().manual_seed(3)
    n = 700
    o = s.camera.origin.expand(n, 3) + 0.1 * torch.randn(n, 3, generator=g)
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=g) * 0.3
                                      + torch.tensor([0.0, -0.05, -1.0]), dim=1)
    tf = torch.where(torch.rand(n, generator=g) < 0.8, 1e30, 0.0)
    _, _, pops, tests = closest_wide_plain(o, d, chunks, t_far=tf, counts=True)
    assert walkcount.count(o, d, tf, chunks, False) == (int(pops.sum()), int(tests.sum()))
    tfa = 5.0 + 30.0 * torch.rand(n, generator=g)
    _, pops, tests = anyhit_wide_plain(o, d, chunks, tfa, counts=True)
    assert walkcount.count(o, d, tfa, chunks, True) == (int(pops.sum()), int(tests.sum()))


def test_recorder_samples_live_rays_and_restores():
    class Backend:
        chunks = ["c"]

        def intersect(self, o, d, scene, alive=None):
            return "hit"

        def occluded(self, o, d, scene, t_far):
            return "blocked"

    be = Backend()
    o = torch.zeros(100, 3)
    alive = torch.arange(100) % 2 == 0
    with walkcount.Recorder(Backend) as rec:
        assert be.intersect(o, o, None, alive) == "hit"
        assert be.occluded(o, o, None, torch.where(alive, 1.0, 0.0)) == "blocked"
        assert be.intersect(o, o, None) == "hit"
    assert Backend.intersect(be, o, o, None) == "hit"
    (a0, o0, _, t0, n0, _), (a1, _, _, t1, n1, _), (_, o2, _, _, n2, _) = rec.calls
    assert (a0, n0, o0.shape[0]) == (False, 50, 4) and (t0 == 1e30).all()
    assert (a1, n1) == (True, 50) and (t1 == 1.0).all()
    assert (n2, o2.shape[0]) == (100, 7)
    assert walkcount.walk_work([(False, o0, o0, t0, 50, [object()])]) is None
