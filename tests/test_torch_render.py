"""blink_torch's render on the CPU against blink: the stochastic direct-
lighting frame of a 20k-triangle Sponza, the committed bunny golden, the
device rule of the entry points, and the CLI."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from blink.api import build_scene as jax_build_scene
from blink.api import render as jax_render
from blink.config import get_config as jax_get_config
from blink_torch.api import build_scene, render
from blink_torch.config import get_config

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "bunny128_sub5_det.npy"


def _close_share(img, ref, atol=1e-4) -> float:
    assert img.shape == ref.shape and np.isfinite(img).all()
    return float(np.isclose(img, ref, atol=atol).mean())


def test_sponza_direct_stochastic_matches_reference():
    """The main path's configuration at 20k triangles and 64x64: the port's
    wide backend against blink's flat-BVH backend, same seed."""
    over = dict(width=64, height=64, spp=1, integrator="direct", sponza_tris=20_000)
    ref_cfg = jax_get_config("sponza").override(backend="bvh", **over)
    ref = np.asarray(jax_render(jax_build_scene(ref_cfg), ref_cfg))
    cfg = get_config("sponza").override(**over)
    img = render(build_scene(cfg), cfg, device="cpu").numpy()
    assert (ref.max(axis=-1) > 0).mean() > 0.3  # the frame is lit
    assert _close_share(img, ref) > 0.999


def test_bunny_golden_on_cpu():
    cfg = get_config("bunny").override(
        width=128, height=128, deterministic=True, bunny_subdiv=5
    )
    img = render(build_scene(cfg), cfg, device="cpu").numpy()
    assert _close_share(img, np.load(GOLDEN)) > 0.999


def test_render_default_device_needs_cuda(monkeypatch):
    """With no CUDA device the entry point raises rather than run on the
    CPU; device='cpu' is the caller's explicit choice."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("bunny").override(width=8, height=8, bunny_subdiv=1)
    scene = build_scene(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        render(scene, cfg)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        render(scene, cfg, device="cuda")


def test_cli_render_cpu(tmp_path):
    out = tmp_path / "img.npy"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "blink_torch", "render", "--config", "bunny",
         "--bunny-subdiv", "2", "--width", "32", "--height", "32",
         "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert '"device": "cpu"' in proc.stdout
    img = np.load(out)
    assert img.shape == (32, 32, 3) and np.isfinite(img).all() and img.max() > 0
