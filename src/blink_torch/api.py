"""Public API: build_scene / render / render_grad / fit (counterpart of
`blink.api`).

`render_grad` takes the value and gradient of pixel MSE through the whole
renderer: traversal gives fixed topology, and autograd flows through hit
refinement, light sampling and shading into any chosen subset of the scene
parameters (geometry, materials, camera). `fit` recovers parameters from a
target image with Adam, with checkpoints, resume and tensorboard
summaries.

Entry points run on the CUDA device unless the caller asks for the CPU:
with no CUDA device and no explicit `device="cpu"` they raise.
"""
from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch

from blink_torch.config import FitConfig, RenderConfig
from blink_torch.obs.profile import span
from blink_torch.scene.scene import Scene

# Named differentiable parameter views into a Scene: name -> (getter,
# merger). Names are what users pass to render_grad and fit.
_PARAMS: dict[str, tuple[Callable[[Scene], torch.Tensor],
                         Callable[[Scene, torch.Tensor], Scene]]] = {
    "sphere_center": (
        lambda s: s.spheres.center,
        lambda s, v: s.replace(spheres=s.spheres.replace(center=v)),
    ),
    "sphere_radius": (
        lambda s: s.spheres.radius,
        lambda s, v: s.replace(spheres=s.spheres.replace(radius=v)),
    ),
    "tri_verts": (
        lambda s: s.triangles.verts,
        # geom_dirty: refine gathers vertices live instead of reading the
        # backend's table, whose geometry lanes are now stale.
        lambda s, v: s.replace(
            triangles=s.triangles.replace(verts=v), geom_dirty=True
        ),
    ),
    "albedo": (
        lambda s: s.materials.albedo,
        lambda s, v: s.replace(materials=s.materials.replace(albedo=v)),
    ),
    "emission": (
        lambda s: s.materials.emission,
        lambda s, v: s.replace(materials=s.materials.replace(emission=v)),
    ),
    "textures": (
        lambda s: s.textures,
        lambda s, v: s.replace(textures=v),
    ),
    "cam_origin": (
        lambda s: s.camera.origin,
        lambda s, v: s.replace(camera=s.camera.replace(origin=v)),
    ),
    "cam_look_at": (
        lambda s: s.camera.look_at,
        lambda s, v: s.replace(camera=s.camera.replace(look_at=v)),
    ),
    "cam_fov": (
        lambda s: s.camera.fov_deg,
        lambda s, v: s.replace(camera=s.camera.replace(fov_deg=v)),
    ),
}

PARAM_NAMES = tuple(_PARAMS)


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


def extract_params(scene: Scene, names: tuple[str, ...]) -> dict[str, torch.Tensor]:
    return {n: _PARAMS[n][0](scene) for n in names}


def merge_params(scene: Scene, params: Mapping[str, torch.Tensor]) -> Scene:
    for n, v in params.items():
        scene = _PARAMS[n][1](scene, v)
    return scene


def params_from_numpy(d: Mapping[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """Carry parameters over from numpy: name -> float32 tensor on
    `device`, copied exactly."""
    unknown = set(d) - set(_PARAMS)
    if unknown:
        raise KeyError(f"unknown parameters {sorted(unknown)}; names: {PARAM_NAMES}")
    return {n: torch.from_numpy(np.array(v, np.float32)).to(device) for n, v in d.items()}


def build_scene(cfg: RenderConfig) -> Scene:
    """The scene a config names, on the host: a preset, or `obj:<path>` (a
    Wavefront OBJ under the default material and camera)."""
    from blink_torch.scene import builders, io
    from blink_torch.scene import scene as sc

    if cfg.scene == "cornell":
        return builders.cornell_box()
    if cfg.scene == "bunny":
        return builders.bunny_scene(cfg.bunny_subdiv)
    if cfg.scene == "sponza":
        return builders.sponza_scene(cfg.sponza_tris)
    if cfg.scene.startswith("obj:"):
        s = sc.make_scene(triangles=io.load_obj(cfg.scene[4:]))
        return s.replace(lights=sc.derive_lights(s.materials, s.spheres, s.triangles))
    raise KeyError(f"unknown scene '{cfg.scene}'")


def _prepare(scene: Scene, cfg: RenderConfig, device, backend):
    from blink_torch.kernels.api import make_backend

    device = resolve_device(device)
    scene = scene.to(device)
    if backend is None:
        backend = make_backend(cfg.backend, scene)
    return device, scene, backend


def render(scene: Scene, cfg: RenderConfig, device=None, backend=None) -> torch.Tensor:
    """(H, W, 3) float32 radiance image on `device` (default: the CUDA
    device). Builds the backend unless one is given."""
    from blink_torch.render.api import render_image

    _, scene, backend = _prepare(scene, cfg, device, backend)
    with torch.no_grad():
        return render_image(scene, cfg, backend)


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def loss_fn(params, scene: Scene, cfg: RenderConfig, backend, target) -> torch.Tensor:
    """Pixel MSE between render(merge(scene, params)) and target."""
    from blink_torch.render.api import render_image

    return mse(render_image(merge_params(scene, params), cfg, backend), target)


def _target(target, device) -> torch.Tensor:
    if not torch.is_tensor(target):
        target = torch.from_numpy(np.array(target, np.float32))
    return target.to(device=device, dtype=torch.float32)


def _leaf_params(scene: Scene, names) -> dict[str, torch.Tensor]:
    """Fresh leaf copies of the named parameters, requiring grad."""
    return {n: v.detach().clone().requires_grad_(True)
            for n, v in extract_params(scene, tuple(names)).items()}


def render_grad(scene: Scene, cfg: RenderConfig, target,
                param_names: tuple[str, ...] = ("sphere_center", "albedo"),
                device=None, backend=None):
    """(loss, grads) of pixel MSE with respect to the named parameters, on
    `device` (default: the CUDA device). loss is a 0-d tensor, grads a dict
    of tensors shaped like the parameters."""
    device, scene, backend = _prepare(scene, cfg, device, backend)
    target = _target(target, device)
    params = _leaf_params(scene, param_names)
    loss = loss_fn(params, scene, cfg, backend, target)
    with span("backward"):
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return loss.detach(), {
        n: torch.zeros_like(p) if g is None else g
        for (n, p), g in zip(params.items(), grads)
    }


def _adam_init(opt: torch.optim.Adam) -> None:
    """Adam's state for every parameter, made now as optax.adam's init
    makes it (Adam would make the same at its first step), so that
    opt.state_dict() is a full template for a checkpoint."""
    for group in opt.param_groups:
        for p in group["params"]:
            opt.state[p] = {"step": torch.tensor(0.0), "exp_avg": torch.zeros_like(p),
                            "exp_avg_sq": torch.zeros_like(p)}


def fit(scene0: Scene, target, cfg: RenderConfig, fit_cfg: FitConfig | None = None,
        device=None, backend=None, resume_from: str = ""):
    """Inverse rendering (config 3): recover the parameters named by
    `fit_cfg.optimize` from a target image by Adam on pixel MSE, one JSON
    line per step to the log and, with `tb_dir`, tensorboard scalars (and a
    render every `tb_image_every` steps). With `ckpt_path`, the parameters
    and Adam's state are saved every `ckpt_every` steps; `resume_from`
    restores them and continues at the saved step. Returns (scene, history
    of the losses of the steps run)."""
    from blink_torch.ckpt import load_ckpt, save_ckpt
    from blink_torch.obs.log import JsonlLogger, TensorboardLogger
    from blink_torch.render.api import render_image

    fit_cfg = fit_cfg or FitConfig()
    device, scene0, backend = _prepare(scene0, cfg, device, backend)
    target = _target(target, device)
    params = _leaf_params(scene0, fit_cfg.optimize)
    for p in params.values():
        # A parameter the loss does not reach still takes optax's update
        # with a zero gradient (Adam skips a parameter whose grad is None).
        p.grad = torch.zeros_like(p)
    # The update of optax.adam: b1 0.9, b2 0.999, eps 1e-8 outside the root.
    opt = torch.optim.Adam(list(params.values()), lr=fit_cfg.lr)
    _adam_init(opt)
    start_step = 0
    if resume_from:
        start_step, saved, opt_state = load_ckpt(resume_from, params, opt.state_dict())
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(saved[n])
        opt.load_state_dict(opt_state)
    history = []
    with JsonlLogger(fit_cfg.log_path) as log, TensorboardLogger(fit_cfg.tb_dir) as tb:
        for step in range(start_step, fit_cfg.steps):
            opt.zero_grad(set_to_none=False)
            loss = loss_fn(params, scene0, cfg, backend, target)
            loss.backward()
            opt.step()
            history.append(float(loss.detach()))
            log.log(step=step, loss=history[-1])
            tb.scalar("fit/loss", history[-1], step)
            if fit_cfg.tb_image_every and (step + 1) % fit_cfg.tb_image_every == 0:
                with torch.no_grad():
                    tb.image("fit/render", render_image(merge_params(scene0, params), cfg,
                                                        backend), step)
            if (fit_cfg.ckpt_path and fit_cfg.ckpt_every > 0
                    and (step + 1) % fit_cfg.ckpt_every == 0):
                save_ckpt(fit_cfg.ckpt_path, step + 1, params, opt.state_dict())
    fitted = {n: p.detach() for n, p in params.items()}
    return merge_params(scene0, fitted), history
