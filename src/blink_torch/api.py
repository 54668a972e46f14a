"""Public API: build_scene / render (counterpart of `blink.api`; gradients
and fitting come with later slices, ROADMAP.md queue 1).

Entry points run on the CUDA device unless the caller asks for the CPU:
with no CUDA device and no explicit `device="cpu"` they raise.
"""
from __future__ import annotations

import torch

from blink_torch.config import RenderConfig
from blink_torch.scene.scene import Scene


def resolve_device(device=None) -> torch.device:
    """`device`, or the current CUDA device when None. Never falls back to
    the CPU: without a CUDA device, the caller must pass device='cpu'."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain torch path on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is unavailable")
    return device


def build_scene(cfg: RenderConfig) -> Scene:
    """The scene a config names, on the host."""
    from blink_torch.scene import builders

    if cfg.scene == "cornell":
        return builders.cornell_box()
    if cfg.scene == "bunny":
        return builders.bunny_scene(cfg.bunny_subdiv)
    if cfg.scene == "sponza":
        return builders.sponza_scene(cfg.sponza_tris)
    raise KeyError(f"unknown scene '{cfg.scene}'")


def render(scene: Scene, cfg: RenderConfig, device=None, backend=None) -> torch.Tensor:
    """(H, W, 3) float32 radiance image on `device` (default: the CUDA
    device). Builds the backend unless one is given."""
    from blink_torch.kernels.api import make_backend
    from blink_torch.render.api import render_image

    device = resolve_device(device)
    scene = scene.to(device)
    if backend is None:
        backend = make_backend(cfg.backend, scene)
    with torch.no_grad():
        return render_image(scene, cfg, backend)
