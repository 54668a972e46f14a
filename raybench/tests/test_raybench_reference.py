"""The reference against the program's plain path at a small size on the
CPU, for every one-card cell of the manifest (the `cell` argument); the
control (the reference in bfloat16 in the program's place) and planted
faults of the timed path come out not correct."""
import hashlib
import time

import numpy as np
import pytest
import torch

from raybench.lib import bench, scenes


def test_scenes_are_the_program_builders():
    from blink_torch.scene import builders

    for ours, theirs in ((scenes.sponza(9000), builders.sponza_scene(9000)),
                         (scenes.bunny(3), builders.bunny_scene(3))):
        for group in ("triangles", "materials", "lights", "camera"):
            for k, v in ours[group].items():
                np.testing.assert_array_equal(v, getattr(getattr(theirs, group), k).numpy())
        np.testing.assert_array_equal(ours["textures"], theirs.textures.numpy())


#: sha256 of each configuration's scene at its own `scene_args`, taken from
#: the scene table the harness had before scenes were files of their own.
SCENE_SHA256 = {
    "sponza1m": "bd9730bcca087cd3cdd9c97f919aafb7e8f5ae436adf5ba80a69fd5f25255ec7",
    "bunny82k": "c7bfbb2dd19a4305218f15b658023058e84316a73c7670cbf1fe10435b12e928",
}


def scene_sha256(arrays: dict) -> str:
    """Every group and field in sorted order: name, dtype, shape, bytes."""
    h = hashlib.sha256()
    for g in sorted(arrays):
        v = arrays[g]
        for k, a in (sorted(v.items()) if isinstance(v, dict) else [("", v)]):
            a = np.ascontiguousarray(a)
            h.update(f"{g}.{k} {a.dtype.str} {a.shape}\n".encode())
            h.update(a.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("config,workload", [("sponza1m", "sponza1m.path"),
                                             ("bunny82k", "bunny82k.grad_softmesh")])
def test_existing_scenes_are_byte_for_byte_as_before(root, config, workload):
    spec = bench.cell_spec(root, workload)
    assert spec.workload["config"] == config
    arrays = spec.scene.build(**spec.config["scene_args"])
    assert scene_sha256(arrays) == SCENE_SHA256[config]


def _sound(spec, seed):
    arrays = bench.scene_arrays(spec, seed)
    prog = bench.Program(spec, seed, "cpu", arrays)
    sseed = bench.sampler_base(seed)
    _, keep, ok = prog.step(sseed)
    assert ok
    return arrays, bench.compare(spec, arrays, seed, [(sseed, keep)], "cpu")


def test_reference_agrees_with_the_program(tiny_cell, cell):
    spec = tiny_cell(cell)
    _, got = _sound(spec, 2**31 + 5)
    assert set(got) == set(spec.limits)
    # The same arithmetic on the same hits: rounding of sums only.
    assert all(v < 1e-5 for v in got.values()), got


def test_a_nan_answer_fails(tiny_cell):
    spec = tiny_cell("sponza1m.grad_materials")
    arrays = bench.scene_arrays(spec, 9)
    prog = bench.Program(spec, 9, "cpu", arrays)
    sseed = bench.sampler_base(9)
    _, (lv, grads), _ = prog.step(sseed)
    grads = dict(grads, albedo=torch.full_like(grads["albedo"], float("nan")))
    got = bench.compare(spec, arrays, 9, [(sseed, (lv, grads))], "cpu")
    assert got["grad_rel.albedo"] == float("inf") > spec.limits["grad_rel.albedo"]


def _control_keep(spec, arrays, seed, sseed):
    """What the program would keep, computed by the reference in bfloat16."""
    settings = bench.render_settings(spec)
    ref = spec.reference
    if spec.traffic["kind"] == "render_grad":
        loss, grads = ref.loss_and_grads(arrays, settings, spec.traffic["params"],
                                         bench.make_target(spec, seed, "cpu"), sseed, "cpu",
                                         torch.bfloat16)
        return loss, grads
    pid = torch.as_tensor(bench.pixel_sample(spec, seed))
    return ref.frame_pixels(arrays, settings, pid, sseed, "cpu", torch.bfloat16).numpy()


def test_control_fails_the_limits(tiny_cell, cell):
    spec = tiny_cell(cell)
    seed = 77
    arrays = bench.scene_arrays(spec, seed)
    sseed = bench.sampler_base(seed)
    got = bench.compare(spec, arrays, seed, [(sseed, _control_keep(spec, arrays, seed, sseed))],
                        "cpu")
    assert any(got[n] > spec.limits[n] for n in got), got


def _break_half(monkeypatch):
    """Half of the batch left out, the mean taken over the rest: the loss
    over the image's first half of rows; a frame of half its samples."""
    import blink_torch.api as api
    import blink_torch.render.api as rapi

    monkeypatch.setattr(api, "mse", lambda a, b: torch.mean((a[: a.shape[0] // 2]
                                                             - b[: b.shape[0] // 2]) ** 2))
    orig = rapi.render_image

    def half_samples(scene, cfg, backend):
        return orig(scene, cfg.override(spp=max(1, cfg.spp // 2)), backend)

    monkeypatch.setattr(rapi, "render_image", half_samples)


def _break_answer(monkeypatch):
    """An answer altered where it is produced: the radiance of every ray
    one per cent high."""
    import blink_torch.render.api as rapi

    orig = rapi.render_rays
    monkeypatch.setattr(rapi, "render_rays", lambda *a, **k: orig(*a, **k) * 1.01)


@pytest.mark.parametrize("fault", [_break_half, _break_answer])
def test_a_broken_timed_path_is_not_correct(tiny_cell, monkeypatch, cell, fault):
    spec = tiny_cell(cell)
    spec.traffic["check"]["steps"] = 1
    if spec.traffic["kind"] == "render":
        spec.traffic["render"]["spp"] = 8
        spec.traffic["render"]["spp_block"] = 4
    ok = bench.run_cell(spec, 3, 0.05, False, "cpu", time.perf_counter())
    assert ok["correct"], ok["checks"]
    fault(monkeypatch)
    bad = bench.run_cell(spec, 3, 0.05, False, "cpu", time.perf_counter())
    assert not bad["correct"], bad["checks"]
