"""blink_torch's tooling against blink's, on the CPU: checkpoints and
resume, tensorboard summaries, profiler traces, OBJ and image I/O, and the
triangle helpers.

- A checkpoint round trip is exact, keyed by path (params.<name>,
  opt.state.<i>.<field>, meta.step).
- fit for 4 steps equals 2 steps, a checkpoint and a resume for 2 more,
  bit for bit (Cornell 16x16, brute, deterministic), with
  tests/test_fit.py::test_fit_resume_continues's checks, at one intra-op
  thread (the port's tests' setting) and at torch's default.
- tb_dir writes tensorboard event files (tests/test_fit.py::
  test_fit_tensorboard_summaries), with TensorFlow hidden: tensorboard
  then writes through its own stub, as where TensorFlow is not installed,
  and imports in under a second instead of 12. Importing the package does
  not import torch.utils.tensorboard.
- render --profile writes a torch.profiler trace holding the annotated
  stage, and the image through save_image_ppm.
- load_obj, save_image_ppm and save_image_npy, an obj: scene,
  triangle_vertices and triangle_area_normal equal blink's.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import load_file

from blink.api import build_scene as jax_build_scene
from blink.config import get_config as jax_get_config
from blink.scene import io as jax_io
from blink.scene import scene as jax_scene
from blink_torch import cli
from blink_torch.api import build_scene, fit, render
from blink_torch.ckpt import load_ckpt, save_ckpt
from blink_torch.config import FitConfig, get_config
from blink_torch.obs.profile import annotate, trace
from blink_torch.scene import io, scene
from test_bvh import _random_tris
from test_torch_build import DEFAULT_THREADS, port_tris

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: tests/test_scene.py::test_obj_loader's file: two faces sharing an edge,
#: uv through vt.
OBJ = """# comment
v 0 0 0
v 1 0 0
v 0 1 0
v 1 1 0
vt 0 0
vt 1 0
vt 0 1
f 1/1 2/2 3/3
f 2/2 4/1 3/3
"""


def _adam_after_a_step():
    params = {"albedo": torch.rand(10, 3, generator=torch.Generator().manual_seed(0)),
              "sphere_center": torch.zeros(8, 3)}
    params = {n: p.requires_grad_(True) for n, p in params.items()}
    opt = torch.optim.Adam(list(params.values()), lr=1e-2)
    sum((p ** 2).sum() for p in params.values()).backward()
    opt.step()
    return params, opt


def test_checkpoint_round_trip_is_exact(tmp_path):
    params, opt = _adam_after_a_step()
    ck = str(tmp_path / "c.safetensors")
    save_ckpt(ck, 7, params, opt.state_dict())
    assert set(load_file(ck)) == {
        "meta.step", "params.albedo", "params.sphere_center",
        *(f"opt.state.{i}.{f}" for i in (0, 1) for f in ("step", "exp_avg", "exp_avg_sq"))}
    like_p = {n: torch.zeros_like(p) for n, p in params.items()}
    _, like_opt = _adam_after_a_step()
    step, got_p, got_opt = load_ckpt(ck, like_p, like_opt.state_dict())
    assert step == 7
    for n, p in params.items():
        assert torch.equal(got_p[n], p.detach())
    want = opt.state_dict()
    for i, st in want["state"].items():
        for f, v in st.items():
            assert torch.equal(got_opt["state"][i][f], v), (i, f)
    assert got_opt["param_groups"] == want["param_groups"]


@pytest.fixture(scope="module")
def fit_case():
    """Cornell 16x16 (brute, deterministic), a target and a scene with
    perturbed albedo; no test changes them."""
    cfg = get_config("fit").override(width=16, height=16, deterministic=True, backend="brute")
    scene0 = build_scene(cfg)
    target = render(scene0, cfg, device="cpu")
    albedo = scene0.materials.albedo
    noise = np.random.default_rng(3).random(tuple(albedo.shape), dtype=np.float32)
    albedo = torch.clamp(albedo + 0.2 * torch.from_numpy(noise), 0.05, 0.95)
    return cfg, scene0.replace(materials=scene0.materials.replace(albedo=albedo)), target


def test_fit_resume_equals_unbroken_fit(tmp_path, fit_case):
    cfg, scene0, target = fit_case
    kw = dict(lr=1e-2, optimize=("albedo",))
    threads = torch.get_num_threads()
    try:
        for n in sorted({threads, DEFAULT_THREADS}):
            torch.set_num_threads(n)
            whole, h = fit(scene0, target, cfg, FitConfig(steps=4, **kw), device="cpu")
            ck = str(tmp_path / f"r{n}.safetensors")
            _, h1 = fit(scene0, target, cfg,
                        FitConfig(steps=2, ckpt_every=2, ckpt_path=ck, **kw), device="cpu")
            resumed, h2 = fit(scene0, target, cfg, FitConfig(steps=4, ckpt_every=0, **kw),
                              device="cpu", resume_from=ck)
            assert len(h2) == 2, n  # steps 2..3 only
            assert h2[-1] <= h1[0], n
            assert h1 + h2 == h, n
            assert torch.equal(resumed.materials.albedo, whole.materials.albedo), n
    finally:
        torch.set_num_threads(threads)


def test_fit_tensorboard_summaries(tmp_path, fit_case, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    cfg, scene0, target = fit_case
    tb = tmp_path / "tb"
    fit(scene0, target, cfg, FitConfig(steps=3, lr=1e-2, optimize=("albedo",),
                                       tb_dir=str(tb), tb_image_every=2), device="cpu")
    files = [f for _, _, fn in os.walk(tb) for f in fn if "tfevents" in f]
    assert files, "no tensorboard event files written"


def test_tensorboard_is_imported_lazily():
    code = ("import sys, blink_torch, blink_torch.api, blink_torch.cli, blink_torch.obs.log, "
            "blink_torch.obs.profile, blink_torch.benchmarks.headline\n"
            "print(sorted(m for m in sys.modules if 'tensorboard' in m or m == 'tensorflow'))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_render_profile_writes_a_trace(tmp_path, capsys):
    logdir = tmp_path / "prof"
    out = tmp_path / "c.ppm"
    assert cli.main(["render", "--config", "cornell", "--width", "16", "--height", "16",
                     "--device", "cpu", "--profile", str(logdir), "--out", str(out)]) == 0
    assert json.loads(capsys.readouterr().out)["rays"] == 256
    (trace_file,) = logdir.glob("*.pt.trace.json")
    assert json.loads(trace_file.read_text())["traceEvents"]
    assert out.read_bytes().startswith(b"P6\n16 16\n255\n")
    with trace(str(tmp_path / "p2")) as prof:
        with annotate("shade"):
            torch.ones(8).sum()
    assert any(e.key == "shade" for e in prof.key_averages())
    with trace("") as none:
        assert none is None


def test_load_obj_matches_reference(tmp_path):
    p = tmp_path / "tri.obj"
    p.write_text(OBJ)
    tris = io.load_obj(str(p), material_id=5)
    ref = jax_io.load_obj(str(p), material_id=5)
    for f in ("verts", "idx", "uv", "material_id"):
        got, want = getattr(tris, f).numpy(), np.asarray(getattr(ref, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    # tests/test_scene.py::test_obj_loader's checks.
    assert tris.idx.shape == (2, 3) and tris.verts.shape == (4, 3)
    assert int(tris.material_id[0]) == 5
    np.testing.assert_allclose(tris.uv[1].numpy(), [1.0, 0.0])


def test_image_files_match_reference(tmp_path):
    img = np.random.default_rng(4).uniform(-0.2, 1.3, (8, 12, 3)).astype(np.float32)
    for name, port, ref in (("a.ppm", io.save_image_ppm, jax_io.save_image_ppm),
                            ("a.npy", io.save_image_npy, jax_io.save_image_npy)):
        port(str(tmp_path / f"port_{name}"), torch.from_numpy(img))
        ref(str(tmp_path / f"ref_{name}"), jnp.asarray(img))
        assert (tmp_path / f"port_{name}").read_bytes() == (tmp_path / f"ref_{name}").read_bytes()


def test_obj_scene_matches_reference(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text(OBJ)
    s = build_scene(get_config("cornell").override(scene=f"obj:{p}"))
    ref = jax_build_scene(jax_get_config("cornell").override(scene=f"obj:{p}"))
    for group in ("triangles", "lights", "materials", "spheres", "camera"):
        a, b = getattr(s, group), getattr(ref, group)
        for f, v in vars(a).items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(getattr(b, f)),
                                          err_msg=f"{group}.{f}")
    assert s.n_triangles == 2 and s.n_lights == 0


def test_triangle_helpers_match_reference():
    tris = _random_tris(200, 13)
    pt = port_tris(tris)
    prim = np.random.default_rng(5).integers(0, 200, (4, 16)).astype(np.int32)
    got = scene.triangle_vertices(pt, torch.from_numpy(prim))
    want = jax_scene.triangle_vertices(tris, jnp.asarray(prim))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    area, n = scene.triangle_area_normal(pt, torch.from_numpy(prim))
    area_ref, n_ref = jax_scene.triangle_area_normal(tris, jnp.asarray(prim))
    assert area.shape == (4, 16) and n.shape == (4, 16, 3)
    # torch's sqrt and XLA's differ by up to 2.4e-7 (ROADMAP.md §3).
    np.testing.assert_allclose(area.numpy(), np.asarray(area_ref), rtol=1e-6)
    np.testing.assert_allclose(n.numpy(), np.asarray(n_ref), rtol=1e-6, atol=1e-7)
