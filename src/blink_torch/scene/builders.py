"""Procedural scene builders (host-side numpy; counterpart of
`blink.scene.builders`, array for array).

  cornell_box   8 spheres + 2 quads, Lambertian
  bunny_scene   bunny-class icosphere mesh + floor + area light
  sponza_scene  Sponza-class colonnaded hall, ~n_tris unique triangles
  sponza_scene_instanced  the same hall as objects plus instances
"""
from __future__ import annotations

import numpy as np
import torch

from blink_torch.scene.scene import (
    Camera,
    Materials,
    Scene,
    Spheres,
    Triangles,
    derive_lights,
    empty_spheres,
    empty_triangles,
    make_scene,
)

F32 = np.float32
I32 = np.int32


def _t(a, dtype) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype))


class MeshBuilder:
    """Accumulates triangle soup + per-triangle materials (host-side)."""

    def __init__(self) -> None:
        self.verts: list[np.ndarray] = []
        self.uvs: list[np.ndarray] = []
        self.idx: list[np.ndarray] = []
        self.mat: list[np.ndarray] = []
        self._nv = 0

    def add_mesh(self, verts, faces, material_id, uv=None):
        verts = np.asarray(verts, F32).reshape(-1, 3)
        faces = np.asarray(faces, I32).reshape(-1, 3)
        if uv is None:
            uv = np.zeros((verts.shape[0], 2), F32)
        self.verts.append(verts)
        self.uvs.append(np.asarray(uv, F32).reshape(-1, 2))
        self.idx.append(faces + self._nv)
        self.mat.append(np.full((faces.shape[0],), material_id, I32))
        self._nv += verts.shape[0]

    def add_quad(self, p0, p1, p2, p3, material_id):
        """Quad p0..p3 (CCW) as two triangles with unit-square UVs."""
        verts = np.array([p0, p1, p2, p3], F32)
        uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], F32)
        faces = np.array([[0, 1, 2], [0, 2, 3]], I32)
        self.add_mesh(verts, faces, material_id, uv)

    def build(self) -> Triangles:
        if not self.verts:
            return empty_triangles()
        return Triangles(
            verts=_t(np.concatenate(self.verts), F32),
            idx=_t(np.concatenate(self.idx), I32),
            uv=_t(np.concatenate(self.uvs), F32),
            material_id=_t(np.concatenate(self.mat), I32),
        )


def icosphere(subdiv: int, radius: float = 1.0, center=(0.0, 0.0, 0.0)):
    """Subdivided icosahedron: 20 * 4**subdiv triangles."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        F32,
    )
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        I32,
    )
    for _ in range(subdiv):
        # Midpoint subdivision with shared (deduplicated) edge midpoints.
        e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
        e_sorted = np.sort(e, axis=1)
        uniq, inv = np.unique(e_sorted, axis=0, return_inverse=True)
        mids = verts[uniq[:, 0]] + verts[uniq[:, 1]]
        mids /= np.linalg.norm(mids, axis=-1, keepdims=True)
        mid_idx = (len(verts) + inv).reshape(3, -1)  # [ab, bc, ca] per face
        ab, bc, ca = mid_idx[0], mid_idx[1], mid_idx[2]
        a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
        faces = np.concatenate(
            [
                np.stack([a, ab, ca], axis=1),
                np.stack([b, bc, ab], axis=1),
                np.stack([c, ca, bc], axis=1),
                np.stack([ab, bc, ca], axis=1),
            ]
        ).astype(I32)
        verts = np.concatenate([verts, mids.astype(F32)])
    verts = verts * radius + np.asarray(center, F32)
    # Spherical UVs for texture tests.
    d = verts - np.asarray(center, F32)
    d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-9)
    uv = np.stack(
        [0.5 + np.arctan2(d[:, 2], d[:, 0]) / (2 * np.pi), 0.5 + np.arcsin(np.clip(d[:, 1], -1, 1)) / np.pi],
        axis=-1,
    ).astype(F32)
    return verts, faces, uv


def box(lo, hi):
    """Axis-aligned box as 12 triangles with outward normals."""
    lo = np.asarray(lo, F32)
    hi = np.asarray(hi, F32)
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    v = np.array(
        [
            [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
            [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1],
        ],
        F32,
    )
    f = np.array(
        [
            [4, 5, 6], [4, 6, 7],  # +z
            [1, 0, 3], [1, 3, 2],  # -z
            [5, 1, 2], [5, 2, 6],  # +x
            [0, 4, 7], [0, 7, 3],  # -x
            [3, 7, 6], [3, 6, 2],  # +y
            [0, 1, 5], [0, 5, 4],  # -y
        ],
        I32,
    )
    return v, f


def checker_texture(res: int = 64, tiles: int = 8, c0=(0.9, 0.9, 0.9), c1=(0.2, 0.3, 0.6)):
    ij = np.indices((res, res)).sum(axis=0) // (res // tiles)
    checker = (ij % 2).astype(F32)[..., None]
    return (np.asarray(c0, F32) * (1 - checker) + np.asarray(c1, F32) * checker).astype(F32)


def _camera(origin, look_at, fov=40.0) -> Camera:
    return Camera(
        origin=_t(origin, F32),
        look_at=_t(look_at, F32),
        up=_t([0.0, 1.0, 0.0], F32),
        fov_deg=_t(fov, F32),
    )


def cornell_box() -> Scene:
    """8 analytic spheres + 2 quads (floor + emissive ceiling panel)."""
    mats = Materials(
        albedo=_t(
            [
                [0.73, 0.73, 0.73],  # 0 floor
                [0.00, 0.00, 0.00],  # 1 light (emission-only)
                [0.65, 0.05, 0.05],  # 2
                [0.12, 0.45, 0.15],  # 3
                [0.05, 0.30, 0.65],  # 4
                [0.80, 0.70, 0.20],  # 5
                [0.70, 0.20, 0.60],  # 6
                [0.20, 0.65, 0.65],  # 7
                [0.85, 0.45, 0.10],  # 8
                [0.50, 0.50, 0.80],  # 9
            ],
            F32,
        ),
        emission=_t(
            np.concatenate(
                [np.zeros((1, 3), F32), np.full((1, 3), 18.0, F32), np.zeros((8, 3), F32)]
            ),
            F32,
        ),
        texture_id=_t(-np.ones((10,), I32), I32),
    )
    mb = MeshBuilder()
    # Floor quad (y=0) and emissive ceiling panel quad (y=2).
    mb.add_quad([-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2], 0)
    mb.add_quad([-0.6, 2.0, -0.6], [-0.6, 2.0, 0.6], [0.6, 2.0, 0.6], [0.6, 2.0, -0.6], 1)
    tris = mb.build()
    # 8 spheres in two rows of four.
    centers, radii, mids = [], [], []
    for i in range(8):
        row, col = divmod(i, 4)
        centers.append([-1.2 + 0.8 * col, 0.3, -0.6 + 1.0 * row])
        radii.append(0.3)
        mids.append(2 + i)
    spheres = Spheres(
        center=_t(centers, F32), radius=_t(radii, F32), material_id=_t(mids, I32)
    )
    lights = derive_lights(mats, spheres, tris)
    cam = _camera([0.0, 1.4, 4.2], [0.0, 0.5, 0.0], fov=50.0)
    return make_scene(spheres, tris, mats, lights, None, cam)


def bunny_scene(subdiv: int = 6) -> Scene:
    """Bunny-class mesh (20*4^subdiv triangles) + floor + area light."""
    mats = Materials(
        albedo=_t([[0.73, 0.73, 0.73], [0, 0, 0], [0.55, 0.44, 0.35]], F32),
        emission=_t([[0, 0, 0], [14.0, 14.0, 14.0], [0, 0, 0]], F32),
        texture_id=_t(-np.ones((3,), I32), I32),
    )
    mb = MeshBuilder()
    mb.add_quad([-4, 0, -4], [4, 0, -4], [4, 0, 4], [-4, 0, 4], 0)
    mb.add_quad([-1, 3.0, -1], [-1, 3.0, 1], [1, 3.0, 1], [1, 3.0, -1], 1)
    v, f, uv = icosphere(subdiv, radius=0.8, center=(0.0, 0.9, 0.0))
    mb.add_mesh(v, f, 2, uv)
    tris = mb.build()
    spheres = empty_spheres()
    lights = derive_lights(mats, spheres, tris)
    cam = _camera([0.0, 1.6, 3.4], [0.0, 0.8, 0.0], fov=45.0)
    return make_scene(spheres, tris, mats, lights, None, cam)


def sponza_scene(n_tris: int = 1_000_000, textured: bool = True, seed: int = 7) -> Scene:
    """Sponza-class hall, ~n_tris unique triangles: floor and walls, a grid
    of pillars of stacked icospheres filling the triangle budget,
    checker-textured floor and columns, one large area light."""
    rng = np.random.default_rng(seed)
    mats_albedo = [
        [0.75, 0.72, 0.68],  # 0 floor (textured)
        [0.0, 0.0, 0.0],  # 1 light
        [0.70, 0.65, 0.58],  # 2 walls
    ]
    mats_emission = [[0, 0, 0], [22.0, 21.0, 19.0], [0, 0, 0]]
    mats_tex = [0 if textured else -1, -1, -1]
    n_col_mats = 6
    for i in range(n_col_mats):
        c = 0.35 + 0.55 * rng.random(3)
        mats_albedo.append(list(c))
        mats_emission.append([0, 0, 0])
        mats_tex.append(1 if (textured and i % 2 == 0) else -1)
    mats = Materials(
        albedo=_t(mats_albedo, F32),
        emission=_t(mats_emission, F32),
        texture_id=_t(mats_tex, I32),
    )
    textures = (
        _t(
            np.stack(
                [
                    checker_texture(64, 8),
                    checker_texture(64, 16, (0.85, 0.8, 0.7), (0.45, 0.35, 0.3)),
                ]
            ),
            F32,
        )
        if textured
        else None
    )

    mb = MeshBuilder()
    hall_x, hall_y, hall_z = 20.0, 8.0, 40.0
    mb.add_quad([-hall_x, 0, -hall_z], [hall_x, 0, -hall_z], [hall_x, 0, hall_z], [-hall_x, 0, hall_z], 0)
    # Side walls + back wall.
    mb.add_quad([-hall_x, 0, -hall_z], [-hall_x, 0, hall_z], [-hall_x, hall_y, hall_z], [-hall_x, hall_y, -hall_z], 2)
    mb.add_quad([hall_x, 0, hall_z], [hall_x, 0, -hall_z], [hall_x, hall_y, -hall_z], [hall_x, hall_y, hall_z], 2)
    mb.add_quad([-hall_x, 0, -hall_z], [-hall_x, hall_y, -hall_z], [hall_x, hall_y, -hall_z], [hall_x, 0, -hall_z], 2)
    mb.add_quad([-6, hall_y - 0.01, -12], [-6, hall_y - 0.01, 12], [6, hall_y - 0.01, 12], [6, hall_y - 0.01, -12], 1)

    # Column budget: each orb is 20*4^3 = 1280 triangles.
    base = sum(len(x) for x in mb.idx)
    per_orb = 20 * 4**3
    n_orbs = max(1, (n_tris - base) // per_orb)
    # Orbs stacked into pillars on a grid.
    stack_h = 4
    n_pillars = max(1, n_orbs // stack_h)
    gx = int(np.ceil(np.sqrt(n_pillars / 2)))
    gz = int(np.ceil(n_pillars / max(gx, 1)))
    placed = 0
    for pz in range(gz):
        for px in range(gx):
            if placed >= n_orbs:
                break
            x = -hall_x * 0.8 + (1.6 * hall_x * 0.8) * (px + 0.5) / gx
            z = -hall_z * 0.9 + (1.8 * hall_z * 0.9) * (pz + 0.5) / gz
            jx, jz = 0.25 * rng.standard_normal(2)
            for s in range(stack_h):
                if placed >= n_orbs:
                    break
                r = 0.5 - 0.06 * s + 0.05 * rng.random()
                v, f, uv = icosphere(3, radius=r, center=(x + jx, 0.5 + 1.0 * s, z + jz))
                mb.add_mesh(v, f, 3 + int(rng.integers(n_col_mats)), uv)
                placed += 1
    tris = mb.build()
    spheres = empty_spheres()
    lights = derive_lights(mats, spheres, tris)
    cam = _camera([0.0, 3.0, hall_z * 0.95], [0.0, 2.0, 0.0], fov=55.0)
    return make_scene(spheres, tris, mats, lights, textures, cam)


def sponza_scene_instanced(n_tris: int = 1_000_000, seed: int = 7):
    """Config 4's hall as unique objects plus instance transforms (the
    "2-level BVH" form of sponza_scene): the hall shell (floor, walls,
    light) and one unit icosphere per column material; an identity
    instance of the hall and a scaled, translated icosphere instance per
    orb. Returns (object_tris, obj_of_inst, o2w, scene), `scene` holding
    the flattened world-space triangles (bvh.tlas.instance_scene_triangles),
    the geometry a two-level walk sees, so the flat walks and the
    two-level walk compare directly (benchmarks/tlas_probe.py)."""
    from blink_torch.bvh.tlas import instance_scene_triangles

    rng = np.random.default_rng(seed)
    mats_albedo = [
        [0.75, 0.72, 0.68],
        [0.0, 0.0, 0.0],
        [0.70, 0.65, 0.58],
    ]
    mats_emission = [[0, 0, 0], [22.0, 21.0, 19.0], [0, 0, 0]]
    mats_tex = [-1, -1, -1]
    n_col_mats = 6
    for i in range(n_col_mats):
        c = 0.35 + 0.55 * rng.random(3)
        mats_albedo.append(list(c))
        mats_emission.append([0, 0, 0])
        mats_tex.append(-1)
    mats = Materials(
        albedo=_t(mats_albedo, F32),
        emission=_t(mats_emission, F32),
        texture_id=_t(mats_tex, I32),
    )

    # Object 0: the hall shell (identity instance).
    mb = MeshBuilder()
    hall_x, hall_y, hall_z = 20.0, 8.0, 40.0
    mb.add_quad([-hall_x, 0, -hall_z], [hall_x, 0, -hall_z], [hall_x, 0, hall_z], [-hall_x, 0, hall_z], 0)
    mb.add_quad([-hall_x, 0, -hall_z], [-hall_x, 0, hall_z], [-hall_x, hall_y, hall_z], [-hall_x, hall_y, -hall_z], 2)
    mb.add_quad([hall_x, 0, hall_z], [hall_x, 0, -hall_z], [hall_x, hall_y, -hall_z], [hall_x, hall_y, hall_z], 2)
    mb.add_quad([-hall_x, 0, -hall_z], [-hall_x, hall_y, -hall_z], [hall_x, hall_y, -hall_z], [hall_x, 0, -hall_z], 2)
    mb.add_quad([-6, hall_y - 0.01, -12], [-6, hall_y - 0.01, 12], [6, hall_y - 0.01, 12], [6, hall_y - 0.01, -12], 1)
    hall = mb.build()

    # Objects 1..n_col_mats: a unit icosphere per column material.
    objects = [hall]
    for i in range(n_col_mats):
        ob = MeshBuilder()
        v, f, uv = icosphere(3, radius=1.0, center=(0.0, 0.0, 0.0))
        ob.add_mesh(v, f, 3 + i, uv)
        objects.append(ob.build())

    base = hall.idx.shape[0]
    per_orb = 20 * 4**3
    n_orbs = max(1, (n_tris - base) // per_orb)
    stack_h = 4
    n_pillars = max(1, n_orbs // stack_h)
    gx = int(np.ceil(np.sqrt(n_pillars / 2)))
    gz = int(np.ceil(n_pillars / max(gx, 1)))
    obj_of_inst = [0]
    o2w = [np.concatenate([np.eye(3, dtype=F32), np.zeros((3, 1), F32)], axis=1)]
    placed = 0
    for pz in range(gz):
        for px in range(gx):
            if placed >= n_orbs:
                break
            x = -hall_x * 0.8 + (1.6 * hall_x * 0.8) * (px + 0.5) / gx
            z = -hall_z * 0.9 + (1.8 * hall_z * 0.9) * (pz + 0.5) / gz
            jx, jz = 0.25 * rng.standard_normal(2)
            for s in range(stack_h):
                if placed >= n_orbs:
                    break
                r = 0.5 - 0.06 * s + 0.05 * rng.random()
                m = np.zeros((3, 4), F32)
                m[:, :3] = r * np.eye(3, dtype=F32)
                m[:, 3] = [x + jx, 0.5 + 1.0 * s, z + jz]
                obj_of_inst.append(1 + int(rng.integers(n_col_mats)))
                o2w.append(m)
                placed += 1
    obj_of_inst = np.asarray(obj_of_inst, I32)
    o2w = np.stack(o2w)

    tris = instance_scene_triangles(objects, obj_of_inst, o2w)
    spheres = empty_spheres()
    lights = derive_lights(mats, spheres, tris)
    cam = _camera([0.0, 3.0, hall_z * 0.95], [0.0, 2.0, 0.0], fov=55.0)
    scene = make_scene(spheres, tris, mats, lights, None, cam)
    return objects, obj_of_inst, o2w, scene
