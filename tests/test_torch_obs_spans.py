"""blink_torch's stage spans and walk-lane counters (obs.profile), on the
CPU.

- Without a profiler, span() returns one shared no-op context, no
  record_function is made, count() keeps nothing and no object made in
  obs/profile.py stays alive.
- Under torch.profiler (CPU activity), render_grad of the direct
  integrator and a path render with compaction open their stage ranges,
  nested as obs/profile.py lists them; a soft-mesh render_grad opens
  blink.soft.
- walk_lanes.* and walk_live.* equal the lane counts and live lanes of a
  known batch.
- Images and gradients are bit-identical with the profiler on and off.
"""
import collections
import contextlib
import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from blink_torch.api import build_scene, render, render_grad
from blink_torch.config import RenderConfig, get_config
from blink_torch.kernels.api import make_backend
from blink_torch.obs import profile as bp
from blink_torch.scene.builders import bunny_scene
from test_torch_build import scene_numpy  # noqa: F401  (one intra-op thread)

SIZE = 32
GRAD = RenderConfig(scene="sponza", sponza_tris=3000, width=SIZE, height=SIZE, spp=1,
                    integrator="direct", backend="wide", seed=11)
PATH = GRAD.override(integrator="path", spp=2, max_depth=3, compact=True, rr_start=1)
PARAMS = ("albedo", "tri_verts")


@pytest.fixture(scope="module")
def sponza():
    scene = build_scene(GRAD)
    return scene, make_backend("wide", scene)


@pytest.fixture(autouse=True)
def _fresh_counts():
    bp.reset_counts()
    yield
    bp.reset_counts()


def _target():
    return torch.full((SIZE, SIZE, 3), 0.25)


def _stages(prof):
    """[(name, [enclosing blink.* names, innermost first])] of every
    blink.* range the profiler recorded."""
    out = []
    for e in prof.events():
        if e.name.startswith("blink."):
            up, p = [], e.cpu_parent
            while p is not None:
                if p.name.startswith("blink."):
                    up.append(p.name)
                p = p.cpu_parent
            out.append((e.name, up))
    return out


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _stages(prof)


def test_without_a_profiler_nothing_is_recorded(sponza, monkeypatch):
    scene, backend = sponza
    assert not bp.recording()
    assert bp.span("camera") is bp.span("nee") is bp._OFF
    assert isinstance(bp._OFF, contextlib.nullcontext)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) made with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    render_grad(scene, GRAD, _target(), PARAMS, device="cpu", backend=backend)
    render(scene, PATH, device="cpu", backend=backend)
    assert bp.counts() == {}

    def loop():
        for _ in range(1000):
            with bp.span("sampler"):
                pass
            bp.count("walk_lanes.closest", 4096)

    loop()
    tracemalloc.start()
    try:
        loop()
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    kept = snap.filter_traces([tracemalloc.Filter(True, bp.__file__),
                               tracemalloc.Filter(True, contextlib.__file__)])
    assert kept.statistics("filename") == []
    assert bp.counts() == {}


def test_render_grad_direct_opens_its_stages_nested(sponza):
    scene, backend = sponza
    _, stages = _traced(lambda: render_grad(scene, GRAD, _target(), PARAMS, device="cpu",
                                            backend=backend))
    n = collections.Counter(name for name, _ in stages)
    assert n["blink.render"] == n["blink.backward"] == n["blink.camera"] == 1
    assert n["blink.closest"] == n["blink.refine"] == n["blink.nee"] == 1
    assert n["blink.shadow"] == 1 and n["blink.scatter_tri_verts"] == 1
    assert n["blink.sampler"] >= 4
    assert not {"blink.bounce", "blink.compact", "blink.soft"} & set(n)
    for name, up in stages:
        if name == "blink.render" or name == "blink.backward":
            assert up == [], name
        elif name == "blink.shadow":
            assert up == ["blink.nee", "blink.render"]
        elif name == "blink.scatter_tri_verts":
            # On the CPU the backward runs on the calling thread.
            assert up == ["blink.backward"]
        elif name == "blink.sampler":
            assert up[-1] == "blink.render" and set(up) <= {"blink.camera", "blink.nee",
                                                            "blink.render"}
        else:
            assert up == ["blink.render"], (name, up)


def test_path_render_opens_bounce_and_compact(sponza):
    scene, backend = sponza
    _, stages = _traced(lambda: render(scene, PATH, device="cpu", backend=backend))
    n = collections.Counter(name for name, _ in stages)
    walks = PATH.spp * PATH.max_depth
    assert n["blink.render"] == 1 and n["blink.camera"] == PATH.spp
    for stage in ("closest", "refine", "nee", "shadow", "bounce"):
        assert n[f"blink.{stage}"] == walks, stage
    # One compaction a bounce, and the inverse gather of each sample.
    assert n["blink.compact"] == walks + PATH.spp
    for name, up in stages:
        if name in ("blink.bounce", "blink.compact", "blink.closest", "blink.refine"):
            assert up == ["blink.render"], (name, up)
        if name == "blink.sampler" and "blink.bounce" in up:
            assert up == ["blink.bounce", "blink.render"]


def test_soft_mesh_render_grad_opens_soft():
    cfg = get_config("bunny").override(width=16, height=16, spp=1, deterministic=True,
                                       backend="wide", soft_sigma=1.0, soft_mesh=True)
    scene = bunny_scene(2)
    backend = make_backend("wide", scene)
    _, stages = _traced(lambda: render_grad(scene, cfg, torch.zeros((16, 16, 3)),
                                            ("tri_verts",), device="cpu", backend=backend))
    soft = [up for name, up in stages if name == "blink.soft"]
    assert soft and all(up == ["blink.render"] for up in soft)
    inside = collections.Counter(name for name, up in stages if "blink.soft" in up)
    assert inside["blink.closest"] == 1 and inside["blink.nee"] >= 1
    assert inside["blink.shadow"] >= 1


def test_walk_counters_count_lanes_and_live_lanes(sponza):
    scene, backend = sponza
    g = torch.Generator().manual_seed(5)
    n = 3000
    o = scene.camera.origin.expand(n, 3).contiguous()
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1)
    alive = torch.rand(n, generator=g) < 0.4
    t_far = torch.where(torch.rand(n, generator=g) < 0.7, 5.0, 0.0)
    with profile(activities=[ProfilerActivity.CPU]):
        backend.intersect(o, d, scene, alive=alive)
        backend.intersect(o[:100], d[:100], scene)
        backend.occluded(o, d, scene, t_far)
    assert bp.counts() == {
        "walk_lanes.closest": n + 100,
        "walk_live.closest": int(alive.sum()) + 100,
        "walk_lanes.anyhit": n,
        "walk_live.anyhit": int((t_far > 0).sum()),
    }
    assert 0 < int(alive.sum()) < n and 0 < int((t_far > 0).sum()) < n
    bp.reset_counts()
    assert bp.counts() == {}


def test_profiler_leaves_images_and_gradients_bit_identical(sponza):
    scene, backend = sponza
    loss, grads = render_grad(scene, GRAD, _target(), PARAMS, device="cpu", backend=backend)
    img = render(scene, PATH, device="cpu", backend=backend)
    (loss_on, grads_on), _ = _traced(lambda: render_grad(scene, GRAD, _target(), PARAMS,
                                                         device="cpu", backend=backend))
    img_on, _ = _traced(lambda: render(scene, PATH, device="cpu", backend=backend))
    assert torch.equal(loss, loss_on)
    assert all(torch.equal(grads[k], grads_on[k]) for k in PARAMS)
    assert torch.equal(img, img_on)
    assert float(img.abs().sum()) > 0 and float(grads["tri_verts"].abs().sum()) > 0
