"""Scene representation: plain dataclasses of tensors (counterpart of
`blink.scene.scene`).

Quads are two triangles. Counts are shapes: a scene with no spheres has
shape-(0, ...) sphere tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from blink_torch.core import vec

# Light kinds
LIGHT_TRI = 0
LIGHT_SPHERE = 1


class _Tensors:
    """`.to(device)` for a dataclass whose fields are tensors or such
    dataclasses (other fields are carried as they are), and `.replace`."""

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)

    def to(self, device):
        updates = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (torch.Tensor, _Tensors)):
                updates[f.name] = v.to(device)
        return dataclasses.replace(self, **updates)


@dataclasses.dataclass(frozen=True)
class Camera(_Tensors):
    """Pinhole camera."""

    origin: torch.Tensor  # (3,)
    look_at: torch.Tensor  # (3,)
    up: torch.Tensor  # (3,)
    fov_deg: torch.Tensor  # () vertical field of view


@dataclasses.dataclass(frozen=True)
class Spheres(_Tensors):
    center: torch.Tensor  # (S, 3) f32
    radius: torch.Tensor  # (S,) f32
    material_id: torch.Tensor  # (S,) i32


@dataclasses.dataclass(frozen=True)
class Triangles(_Tensors):
    verts: torch.Tensor  # (V, 3) f32
    idx: torch.Tensor  # (T, 3) i32
    uv: torch.Tensor  # (V, 2) f32 per-vertex texture coordinates
    material_id: torch.Tensor  # (T,) i32


@dataclasses.dataclass(frozen=True)
class Materials(_Tensors):
    albedo: torch.Tensor  # (M, 3) f32 base color
    emission: torch.Tensor  # (M, 3) f32 (0 for non-emitters)
    texture_id: torch.Tensor  # (M,) i32, -1 = untextured


@dataclasses.dataclass(frozen=True)
class Lights(_Tensors):
    """Explicit NEE light list referencing emissive primitives."""

    kind: torch.Tensor  # (L,) i32 LIGHT_TRI | LIGHT_SPHERE
    prim: torch.Tensor  # (L,) i32 index into triangles.idx or spheres.center


@dataclasses.dataclass(frozen=True)
class Scene(_Tensors):
    spheres: Spheres
    triangles: Triangles
    materials: Materials
    lights: Lights
    textures: torch.Tensor  # (K, R, R, 3) f32 texture atlas (K may be 0)
    camera: Camera
    #: Set when triangle vertices were swapped for parameters (api's
    #: merge_params): a backend's precomputed shade table then has stale
    #: geometry lanes, and refine gathers vertices live.
    geom_dirty: bool = False

    @property
    def device(self) -> torch.device:
        return self.triangles.verts.device

    @property
    def n_spheres(self) -> int:
        return self.spheres.radius.shape[0]

    @property
    def n_triangles(self) -> int:
        return self.triangles.idx.shape[0]

    @property
    def n_lights(self) -> int:
        return self.lights.kind.shape[0]


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.int32))


def empty_spheres() -> Spheres:
    return Spheres(
        center=torch.zeros((0, 3), dtype=torch.float32),
        radius=torch.zeros((0,), dtype=torch.float32),
        material_id=torch.zeros((0,), dtype=torch.int32),
    )


def empty_triangles() -> Triangles:
    return Triangles(
        verts=torch.zeros((0, 3), dtype=torch.float32),
        idx=torch.zeros((0, 3), dtype=torch.int32),
        uv=torch.zeros((0, 2), dtype=torch.float32),
        material_id=torch.zeros((0,), dtype=torch.int32),
    )


def make_scene(
    spheres: Spheres | None = None,
    triangles: Triangles | None = None,
    materials: Materials | None = None,
    lights: Lights | None = None,
    textures: torch.Tensor | None = None,
    camera: Camera | None = None,
) -> Scene:
    if spheres is None:
        spheres = empty_spheres()
    if triangles is None:
        triangles = empty_triangles()
    if materials is None:
        materials = Materials(
            albedo=torch.ones((1, 3), dtype=torch.float32) * 0.8,
            emission=torch.zeros((1, 3), dtype=torch.float32),
            texture_id=-torch.ones((1,), dtype=torch.int32),
        )
    if lights is None:
        lights = Lights(
            kind=torch.zeros((0,), dtype=torch.int32),
            prim=torch.zeros((0,), dtype=torch.int32),
        )
    if textures is None:
        textures = torch.zeros((0, 8, 8, 3), dtype=torch.float32)
    if camera is None:
        camera = Camera(
            origin=_f32([0.0, 1.0, 3.0]),
            look_at=_f32([0.0, 1.0, 0.0]),
            up=_f32([0.0, 1.0, 0.0]),
            fov_deg=_f32(45.0),
        )
    return Scene(
        spheres=spheres,
        triangles=triangles,
        materials=materials,
        lights=lights,
        textures=textures,
        camera=camera,
    )


def derive_lights(materials: Materials, spheres: Spheres, triangles: Triangles) -> Lights:
    """The NEE light list from emissive materials (host-side numpy)."""
    em = materials.emission.cpu().numpy()
    is_emissive = em.sum(axis=-1) > 0.0
    tri_ids = np.nonzero(is_emissive[triangles.material_id.cpu().numpy()])[0]
    sph_ids = np.nonzero(is_emissive[spheres.material_id.cpu().numpy()])[0]
    kinds = np.concatenate(
        [
            np.full(tri_ids.shape, LIGHT_TRI, np.int32),
            np.full(sph_ids.shape, LIGHT_SPHERE, np.int32),
        ]
    )
    prims = np.concatenate([tri_ids, sph_ids]).astype(np.int32)
    return Lights(kind=_i32(kinds), prim=_i32(prims))


_GROUPS = {
    "spheres": Spheres,
    "triangles": Triangles,
    "materials": Materials,
    "lights": Lights,
    "camera": Camera,
}


def scene_from_numpy(d: Mapping[str, Any]) -> Scene:
    """Carry a scene over from numpy: `d` maps each `Scene` field to a dict
    of numpy arrays by field name (`textures` to one array), as a `blink`
    Scene's fields read back with `np.asarray`. Arrays are copied exactly,
    with int32/float32 as the field types."""
    parts = {}
    for name, cls in _GROUPS.items():
        fields = {}
        for f in dataclasses.fields(cls):
            a = np.asarray(d[name][f.name])
            fields[f.name] = torch.from_numpy(
                a.astype(np.int32 if a.dtype.kind in "iu" else np.float32)
            )
        parts[name] = cls(**fields)
    return Scene(textures=_f32(d["textures"]), **parts)
