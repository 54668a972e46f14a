"""The `tlas` backend (bvh.tlas.build_tlas, and kernels.traverse_tlas: the
plain two-level walk and csrc/wide_walk.cu's tlas_wide_group_walk) on the
instanced hall and on objects under random rotations, non-uniform scales
and translations.

On the CPU: the plain walk against the structural reference
(traverse_two_level) and the flat wide walk over the flattened triangles
by tests/test_tlas.py's rule (hits equal, t within 1e-5), api.render
through `tlas` against `wide`, the scene's `instances` group, and the
backend's counters, taken after a profiler's recording from a sample of
each call's lanes. On the card (`gpu`): the kernel against the plain walk,
prim equal and t within 1e-6, with the counting build's counters against
the plain walk's counts. chip_smoke.py's tlas phase holds the kernel so
at config 4's full size."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from blink_torch.api import render
from blink_torch.benchmarks.tlas_probe import probe_rays
from blink_torch.bvh import tlas as tl
from blink_torch.config import get_config
from blink_torch.kernels import traverse_tlas as tt
from blink_torch.kernels.api import TLAS_SAMPLE, make_backend
from blink_torch.kernels.traverse_wide import traverse_anyhit_wide, traverse_closest_wide
from blink_torch.obs import profile as bp
from blink_torch.scene.builders import box, icosphere, sponza_scene_instanced
from blink_torch.scene.scene import Triangles, make_scene, scene_from_numpy

TOL = 1e-5


def _tris(v, f) -> Triangles:
    return Triangles(verts=torch.as_tensor(np.asarray(v, np.float32)),
                     idx=torch.as_tensor(np.asarray(f, np.int32)), uv=torch.zeros((len(v), 2)),
                     material_id=torch.zeros(len(f), dtype=torch.int32))


def _hall(n_tris: int = 8_000):
    """sponza_scene_instanced(n_tris), its scene carrying `instances`."""
    objects, insts, o2w, scene = sponza_scene_instanced(n_tris)
    return objects, insts, o2w, scene.replace(instances=tl.instances_of(objects, insts, o2w))


def _random_scene():
    """An icosphere and a box, 24 instances of random rotations,
    non-uniform scales and translations."""
    rng = np.random.default_rng(4)
    objects = [_tris(*icosphere(2)[:2]), _tris(*box([-1, -1, -1], [1, 1, 1]))]
    insts = np.arange(24) % 2
    o2w = np.zeros((24, 3, 4), np.float32)
    for i in range(24):
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        o2w[i, :, :3] = q * rng.uniform(0.3, 1.5, 3)
        o2w[i, :, 3] = rng.uniform(-5, 5, 3)
    scene = make_scene(triangles=tl.instance_scene_triangles(objects, insts, o2w))
    return objects, insts, o2w, scene.replace(instances=tl.instances_of(objects, insts, o2w))


def _rays(kind: str, scene, n: int = 256):
    """Probe rays down the hall plus rays from its camera at each
    instance's centre; random rays into the random scene."""
    if kind == "hall":
        o, d = probe_rays(n, "cpu")
        c = scene.instances.o2w[:, :, 3]
        o2 = scene.camera.origin.expand(c.shape[0], 3)
        d2 = torch.nn.functional.normalize(c - o2, dim=1)
        return torch.cat([o, o2]).contiguous(), torch.cat([d, d2]).contiguous()
    g = torch.Generator().manual_seed(5)
    o = torch.rand((n, 3), generator=g) * 16 - 8
    aim = torch.rand((n, 3), generator=g) * 8 - 4
    return o, torch.nn.functional.normalize(aim - o, dim=1)


def _shadow_bounds(t, hit):
    """Any-hit bounds: part short of each hit, part past it, the misses
    long."""
    g = torch.Generator().manual_seed(6)
    return torch.where(hit, t * torch.rand(t.shape, generator=g) * 1.5, 40.0)


@pytest.mark.parametrize("kind", ["hall", "random"])
def test_plain_walk_matches_two_level_and_flat(kind):
    objects, insts, o2w, scene = _hall() if kind == "hall" else _random_scene()
    acc = tl.build_tlas(scene.instances)
    o, d = _rays(kind, scene)
    t, prim = tt.closest_tlas_plain(o, d, acc)
    hit = prim >= 0
    assert 0.2 < hit.float().mean() < 1.0
    t_ref, p_ref = tl.traverse_two_level(o, d, tl.build_two_level(objects, insts, o2w))
    t_fl, p_fl = traverse_closest_wide(o, d, make_backend("wide", scene).chunks)
    for t_other, pp in ((t_ref, p_ref), (t_fl, p_fl)):
        assert torch.equal(hit, pp >= 0)
        torch.testing.assert_close(t[hit], t_other[hit], rtol=TOL, atol=TOL)
        assert (prim == pp).float().mean() > 0.99
    t_far = _shadow_bounds(t, hit)
    blocked = tt.anyhit_tlas_plain(o, d, acc, t_far)
    assert 0.05 < blocked.float().mean() < 0.95
    assert torch.equal(blocked, traverse_anyhit_wide(o, d, make_backend("wide", scene).chunks,
                                                     t_far))


def test_render_tlas_matches_wide():
    """A path-traced frame of the tiny instanced hall, the sponza preset's
    integrator at 32x32, 4 spp and depth 2: 99.9% of texels within 1e-4."""
    *_, scene = _hall()
    cfg = get_config("sponza").override(width=32, height=32, spp=4, max_depth=2)
    imgs = [render(scene, cfg.override(backend=b), device="cpu") for b in ("wide", "tlas")]
    close = (imgs[0] - imgs[1]).abs() <= 1e-4
    assert close.float().mean() >= 0.999 and imgs[0].abs().sum() > 0


def test_scene_from_numpy_carries_instances():
    objects, insts, o2w, scene = _hall()
    inst = scene.instances
    groups = {g: {f.name: getattr(getattr(scene, g), f.name).numpy()
                  for f in dataclasses.fields(getattr(scene, g))}
              for g in ("spheres", "triangles", "materials", "lights", "camera")}
    arrays = {**groups, "textures": scene.textures.numpy(),
              "instances": {"objects": {"verts": inst.verts.numpy(),
                                        "idx": inst.idx.numpy().astype(np.int64),
                                        "tri_start": inst.tri_start.numpy()},
                            "obj_of_inst": insts, "o2w": o2w.astype(np.float64)}}
    got = scene_from_numpy(arrays).to(torch.device("cpu")).instances
    for f in dataclasses.fields(inst):
        want, have = getattr(inst, f.name), getattr(got, f.name)
        assert have.dtype == want.dtype and torch.equal(have, want), f.name
    one = scene_from_numpy({**arrays, "instances": {
        "objects": {"verts": objects[1].verts.numpy(), "idx": objects[1].idx.numpy()},
        "obj_of_inst": np.zeros(2, np.int32), "o2w": o2w[1:3]}}).instances
    assert one.tri_start.tolist() == [0, objects[1].idx.shape[0]]


def test_backend_needs_instances_and_counts_its_walk():
    """make_backend('tlas') names the missing group; under a profiler the
    backend's walks count nothing while it records, and when the counters
    are read, the plain walk's counts over every TLAS_SAMPLE-th lane,
    scaled to the call's lanes; with no profiler it records nothing."""
    *_, scene = _hall()
    with pytest.raises(ValueError, match="instances"):
        make_backend("tlas", scene.replace(instances=None))
    be = make_backend("tlas", scene)
    assert be.chunks is None and be.tlas is not None
    o, d = _rays("hall", scene, 4096)
    n = o.shape[0]
    t_far = torch.full((n,), 5.0)
    alive = torch.arange(n) % 3 > 0
    s = slice(None, None, TLAS_SAMPLE)
    _, _, per_ray = tt.closest_tlas_plain(o[s], d[s], be.tlas,
                                          torch.where(alive, 1e30, 0.0)[s], counts=True)
    _, per_ray_any = tt.anyhit_tlas_plain(o[s], d[s], be.tlas, t_far[s], counts=True)
    m = per_ray.shape[1]
    assert m == -(-n // TLAS_SAMPLE)
    bp.reset_counts()
    calls = []
    walk = tt._walk

    def counted(*args, **kw):
        calls.append(args[0].shape[0])
        return walk(*args, **kw)

    tt._walk = counted
    try:
        be.intersect(o, d, scene, alive)
        be.occluded(o, d, scene, t_far)
        assert bp.counts() == {}
        with profile(activities=[ProfilerActivity.CPU]):
            be.intersect(o, d, scene, alive)
            be.occluded(o, d, scene, t_far)
            assert calls == [n, n] * 2  # no counting pass while recording
        got = bp.counts()
        assert calls == [n, n] * 2 + [m, m]
    finally:
        tt._walk = walk
        bp.reset_counts()
    for k, name in enumerate(tt.COUNTERS):
        for kind, c in (("closest", per_ray), ("anyhit", per_ray_any)):
            want = (int(c[k].sum()) * n + m // 2) // m
            assert got[f"{name}.{kind}"] == want > 0, (name, kind)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _hold(acc, o, d, t_far, t_bound):
    """Kernel against plain walk, closest hit (bounded by t_bound) and any
    hit (t_far), on the card: one launch a call, prim and blocked equal, t
    within 1e-6; the counting build's output the same and its counters
    the plain walk's sums."""
    for any_hit in (False, True):
        before = dict(tt.LAUNCHES)
        tf = t_far if any_hit else t_bound
        out, counts = tt.walk_counts(any_hit, o, d, acc, tf)
        if any_hit:
            got = tt.traverse_anyhit_tlas(o, d, acc, t_far)
            want, per_ray = tt.anyhit_tlas_plain(o, d, acc, t_far, counts=True)
            assert torch.equal(got, want) and torch.equal(out, want)
        else:
            t, got = tt.traverse_closest_tlas(o, d, acc, t_far=t_bound)
            t_w, p_w, per_ray = tt.closest_tlas_plain(o, d, acc, t_bound, counts=True)
            assert torch.equal(got, p_w) and torch.equal(out[1], p_w)
            for x in (t, out[0]):
                torch.testing.assert_close(x, t_w, rtol=1e-6, atol=1e-6)
        entry = "tlas_anyhit" if any_hit else "tlas_closest"
        assert tt.LAUNCHES == {**before, entry: before[entry] + 1}
        assert counts.tolist() == per_ray.sum(1).tolist()


@pytest.mark.gpu
def test_kernel_matches_plain_walk_on_gpu():
    dev = _cuda()
    for kind in ("hall", "random"):
        *_, scene = _hall() if kind == "hall" else _random_scene()
        acc = tl.build_tlas(scene.instances).to(dev)
        o, d = (x.to(dev) for x in _rays(kind, scene, 4096))
        t, prim = tt.closest_tlas_plain(o, d, acc)
        t_bound = torch.where(torch.arange(o.shape[0], device=dev) % 7 == 0, 0.0, 1e30)
        _hold(acc, o, d, _shadow_bounds(t.cpu(), (prim >= 0).cpu()).to(dev), t_bound)
