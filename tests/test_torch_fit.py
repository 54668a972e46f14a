"""blink_torch's fit against blink's, and the fit subcommand, on the CPU."""
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blink.api import build_scene as jax_build_scene
from blink.api import fit as jax_fit
from blink.config import FitConfig as JaxFitConfig
from blink.config import get_config as jax_get_config
from blink.render.api import render as jax_render
from blink_torch.api import build_scene, fit
from blink_torch.config import FitConfig, get_config

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_fit_loss_history_matches_reference(tmp_path):
    """5 Adam steps on Cornell 32x32 from the same numpy-perturbed sphere
    centres towards the same target. Adam's first steps are close to
    sign(g) * lr, so a gradient near zero may move the two runs apart; the
    histories agree within rtol 1e-4 (measured 2.5e-6 on the CPU). A
    checkpoint of that fit does not resume another parameter set (a
    missing key) or a scene of 7 spheres (a wrong shape), with blink's
    errors."""
    over = dict(width=32, height=32)
    jcfg = jax_get_config("fit").override(**over)
    jscene = jax_build_scene(jcfg)
    target = np.asarray(jax_render(jscene, jcfg))
    noise = 0.15 * np.random.default_rng(1).standard_normal((8, 3)).astype(np.float32)
    center0 = np.asarray(jscene.spheres.center) + noise
    jscene0 = jscene.replace(spheres=jscene.spheres.replace(center=jnp.asarray(center0)))
    _, ref = jax_fit(jscene0, jnp.asarray(target), jcfg, JaxFitConfig(steps=5))

    cfg = get_config("fit").override(**over)
    scene = build_scene(cfg)
    scene0 = scene.replace(spheres=scene.spheres.replace(
        center=scene.spheres.center + torch.from_numpy(noise)))
    fitted, hist = fit(scene0, target, cfg, FitConfig(steps=5), device="cpu")
    assert len(hist) == 5 and hist[-1] < hist[0]
    np.testing.assert_allclose(hist, ref, rtol=1e-4)
    assert not fitted.spheres.center.requires_grad
    ck = str(tmp_path / "fit.safetensors")
    fit(scene0, target, cfg, FitConfig(steps=1, ckpt_every=1, ckpt_path=ck), device="cpu")
    with pytest.raises(KeyError, match="checkpoint is missing leaf 'params.emission'"):
        fit(scene0, target, cfg, FitConfig(steps=2, optimize=("sphere_center", "emission")),
            device="cpu", resume_from=ck)
    sph = scene0.spheres
    scene7 = scene0.replace(spheres=sph.replace(
        center=sph.center[:7], radius=sph.radius[:7], material_id=sph.material_id[:7]))
    with pytest.raises(ValueError, match=r"checkpoint leaf 'params.sphere_center' has shape "
                                         r"\(8, 3\), template expects \(7, 3\)"):
        fit(scene7, target, cfg, FitConfig(steps=2), device="cpu", resume_from=ck)


def test_cli_fit_cpu(tmp_path):
    log = tmp_path / "fit.jsonl"
    # One intra-op thread, as in the test workers (test_torch_path.py's CLI test).
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "blink_torch", "fit", "--config", "fit",
         "--width", "16", "--height", "16", "--steps", "2", "--device", "cpu",
         "--log", str(log)],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["cmd"] == "fit" and out["steps"] == 2
    assert np.isfinite(out["loss_first"]) and np.isfinite(out["loss_last"])
    steps = [json.loads(line) for line in log.read_text().splitlines()]
    assert [s["step"] for s in steps] == [0, 1]
