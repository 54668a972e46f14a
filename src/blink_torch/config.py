"""Config system: the same frozen dataclasses and presets as `blink.config`,
so a config JSON written by either package loads in the other.

Backends of the port: `auto | brute | wide` (`pallas` is accepted as an
alias of `wide`, the name `blink` gives the same traversal). `auto`
resolves to `brute` at 64 triangles or fewer, else to `wide`
(kernels.api.make_backend).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    scene: str = "cornell"  # cornell | bunny | sponza
    width: int = 256
    height: int = 256
    spp: int = 1
    max_depth: int = 4
    integrator: str = "direct"  # primary | direct | path
    backend: str = "auto"  # auto | brute | wide (alias: pallas)
    seed: int = 0
    jitter: bool = True
    # Deterministic sampling: center-pixel rays + fixed-point light samples
    # (the mode the golden images are rendered in).
    deterministic: bool = False
    # Scene-size knobs (procedural builders).
    bunny_subdiv: int = 6
    sponza_tris: int = 1_000_000
    # Fields read by parts of `blink` this package has not ported yet
    # (ROADMAP.md queue 1); kept so config JSON round-trips.
    soft_sigma: float = 0.0
    soft_mesh: bool = False
    compact: bool = False
    spp_block: int = 0
    rr_start: int = 0
    ray_chunk: int = 0
    donate: bool = True

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "RenderConfig":
        return RenderConfig(**json.loads(s))

    def override(self, **kwargs: Any) -> "RenderConfig":
        kwargs = {k: v for k, v in kwargs.items() if v is not None}
        return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Inverse-rendering loop config (config 3). Checkpoints and tensorboard
    (ckpt_path, tb_dir) wait for the tooling slice: api.fit raises on them."""

    steps: int = 200
    lr: float = 2e-2
    optimize: tuple[str, ...] = ("sphere_center", "albedo")
    ckpt_every: int = 50
    ckpt_path: str = ""
    log_path: str = ""
    tb_dir: str = ""
    tb_image_every: int = 0
    seed: int = 0


PRESETS: dict[str, RenderConfig] = {
    "cornell": RenderConfig(
        scene="cornell", width=256, height=256, spp=1, integrator="direct"
    ),
    "bunny": RenderConfig(
        scene="bunny", width=512, height=512, spp=4, integrator="direct",
        backend="auto",
    ),
    "fit": RenderConfig(
        scene="cornell", width=256, height=256, spp=1, integrator="direct"
    ),
    "sponza": RenderConfig(
        scene="sponza", width=512, height=512, spp=16, integrator="path",
        max_depth=4, backend="auto", spp_block=16, compact=True,
        rr_start=1,
    ),
    "pod": RenderConfig(
        scene="sponza", width=4096, height=4096, spp=64, integrator="path",
        max_depth=4, backend="auto", spp_block=16, compact=True,
        rr_start=1,
    ),
}


def get_config(name: str) -> RenderConfig:
    if name in PRESETS:
        return PRESETS[name]
    if name.endswith(".json"):
        with open(name) as fh:
            return RenderConfig.from_json(fh.read())
    raise KeyError(f"unknown config '{name}'; presets: {sorted(PRESETS)}")
