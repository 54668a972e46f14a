"""Helpers of the benchmark's scene files (`raybench/scenes/<scene>.py`):
host-side numpy, a frozen copy of the program's procedural builders,
array for array, so that a change to the program's builders cannot change
what the benchmark renders.

A scene is a dict of numpy arrays grouped as the program's
`scene_from_numpy` reads them: `spheres`, `triangles`, `materials`,
`lights`, `camera` (each a dict of arrays by field name) and `textures`.
"""
from __future__ import annotations

import numpy as np

F32 = np.float32
I32 = np.int32


class MeshBuilder:
    """Triangle soup with per-triangle materials."""

    def __init__(self) -> None:
        self.verts, self.uvs, self.idx, self.mat = [], [], [], []
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
        verts = np.array([p0, p1, p2, p3], F32)
        uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], F32)
        self.add_mesh(verts, np.array([[0, 1, 2], [0, 2, 3]], I32), material_id, uv)

    def build(self) -> dict:
        return {
            "verts": np.concatenate(self.verts).astype(F32),
            "idx": np.concatenate(self.idx).astype(I32),
            "uv": np.concatenate(self.uvs).astype(F32),
            "material_id": np.concatenate(self.mat).astype(I32),
        }


def icosphere(subdiv: int, radius: float = 1.0, center=(0.0, 0.0, 0.0)):
    """Subdivided icosahedron: 20 * 4**subdiv triangles, spherical uvs."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t], [0, 1, t],
         [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], F32)
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    faces = np.array(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9], [5, 11, 4],
         [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8],
         [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], I32)
    for _ in range(subdiv):
        e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
        uniq, inv = np.unique(np.sort(e, axis=1), axis=0, return_inverse=True)
        mids = verts[uniq[:, 0]] + verts[uniq[:, 1]]
        mids /= np.linalg.norm(mids, axis=-1, keepdims=True)
        ab, bc, ca = (len(verts) + inv.reshape(-1)).reshape(3, -1)
        a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
        faces = np.concatenate([np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1),
                                np.stack([c, ca, bc], 1), np.stack([ab, bc, ca], 1)]).astype(I32)
        verts = np.concatenate([verts, mids.astype(F32)])
    verts = verts * radius + np.asarray(center, F32)
    d = verts - np.asarray(center, F32)
    d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-9)
    uv = np.stack([0.5 + np.arctan2(d[:, 2], d[:, 0]) / (2 * np.pi),
                   0.5 + np.arcsin(np.clip(d[:, 1], -1, 1)) / np.pi], axis=-1).astype(F32)
    return verts, faces, uv


def checker_texture(res: int = 64, tiles: int = 8, c0=(0.9, 0.9, 0.9), c1=(0.2, 0.3, 0.6)):
    ij = np.indices((res, res)).sum(axis=0) // (res // tiles)
    checker = (ij % 2).astype(F32)[..., None]
    return (np.asarray(c0, F32) * (1 - checker) + np.asarray(c1, F32) * checker).astype(F32)


def camera(origin, look_at, fov) -> dict:
    """The `camera` group: a pinhole at `origin` looking at `look_at`."""
    return {"origin": np.asarray(origin, F32), "look_at": np.asarray(look_at, F32),
            "up": np.asarray([0.0, 1.0, 0.0], F32), "fov_deg": np.asarray(fov, F32)}


def assemble(tris: dict, albedo, emission, tex_id, textures, cam: dict) -> dict:
    """The scene dict of a triangle soup (MeshBuilder.build), its
    materials, textures (None: none) and camera; the light list is every
    emissive triangle."""
    emission = np.asarray(emission, F32)
    emissive = emission.sum(axis=-1) > 0.0
    light_prim = np.nonzero(emissive[tris["material_id"]])[0].astype(I32)
    return {
        "spheres": {"center": np.zeros((0, 3), F32), "radius": np.zeros((0,), F32),
                    "material_id": np.zeros((0,), I32)},
        "triangles": tris,
        "materials": {"albedo": np.asarray(albedo, F32), "emission": emission,
                      "texture_id": np.asarray(tex_id, I32)},
        "lights": {"kind": np.zeros(light_prim.shape, I32), "prim": light_prim},
        "textures": (np.zeros((0, 8, 8, 3), F32) if textures is None
                     else np.asarray(textures, F32)),
        "camera": cam,
    }


def bunny(subdiv: int = 6) -> dict:
    """Bunny-class icosphere mesh (20 * 4**subdiv triangles), a floor and
    an area light."""
    mb = MeshBuilder()
    mb.add_quad([-4, 0, -4], [4, 0, -4], [4, 0, 4], [-4, 0, 4], 0)
    mb.add_quad([-1, 3.0, -1], [-1, 3.0, 1], [1, 3.0, 1], [1, 3.0, -1], 1)
    v, f, uv = icosphere(subdiv, radius=0.8, center=(0.0, 0.9, 0.0))
    mb.add_mesh(v, f, 2, uv)
    return assemble(mb.build(), [[0.73, 0.73, 0.73], [0, 0, 0], [0.55, 0.44, 0.35]],
                    [[0, 0, 0], [14.0, 14.0, 14.0], [0, 0, 0]], [-1, -1, -1], None,
                    camera([0.0, 1.6, 3.4], [0.0, 0.8, 0.0], 45.0))


def sponza(n_tris: int = 1_000_000, seed: int = 7) -> dict:
    """Sponza-class hall of about n_tris triangles: floor and walls, a grid
    of pillars of stacked icospheres, checker-textured floor and columns,
    one large area light."""
    rng = np.random.default_rng(seed)
    albedo = [[0.75, 0.72, 0.68], [0.0, 0.0, 0.0], [0.70, 0.65, 0.58]]
    emission = [[0, 0, 0], [22.0, 21.0, 19.0], [0, 0, 0]]
    tex = [0, -1, -1]
    n_col_mats = 6
    for i in range(n_col_mats):
        albedo.append(list(0.35 + 0.55 * rng.random(3)))
        emission.append([0, 0, 0])
        tex.append(1 if i % 2 == 0 else -1)
    textures = np.stack([checker_texture(64, 8),
                         checker_texture(64, 16, (0.85, 0.8, 0.7), (0.45, 0.35, 0.3))])
    mb = MeshBuilder()
    hx, hy, hz = 20.0, 8.0, 40.0
    mb.add_quad([-hx, 0, -hz], [hx, 0, -hz], [hx, 0, hz], [-hx, 0, hz], 0)
    mb.add_quad([-hx, 0, -hz], [-hx, 0, hz], [-hx, hy, hz], [-hx, hy, -hz], 2)
    mb.add_quad([hx, 0, hz], [hx, 0, -hz], [hx, hy, -hz], [hx, hy, hz], 2)
    mb.add_quad([-hx, 0, -hz], [-hx, hy, -hz], [hx, hy, -hz], [hx, 0, -hz], 2)
    mb.add_quad([-6, hy - 0.01, -12], [-6, hy - 0.01, 12], [6, hy - 0.01, 12],
                [6, hy - 0.01, -12], 1)
    base = sum(len(x) for x in mb.idx)
    n_orbs = max(1, (n_tris - base) // (20 * 4**3))
    stack_h = 4
    n_pillars = max(1, n_orbs // stack_h)
    gx = int(np.ceil(np.sqrt(n_pillars / 2)))
    gz = int(np.ceil(n_pillars / max(gx, 1)))
    placed = 0
    for pz in range(gz):
        for px in range(gx):
            if placed >= n_orbs:
                break
            x = -hx * 0.8 + (1.6 * hx * 0.8) * (px + 0.5) / gx
            z = -hz * 0.9 + (1.8 * hz * 0.9) * (pz + 0.5) / gz
            jx, jz = 0.25 * rng.standard_normal(2)
            for s in range(stack_h):
                if placed >= n_orbs:
                    break
                r = 0.5 - 0.06 * s + 0.05 * rng.random()
                v, f, uv = icosphere(3, radius=r, center=(x + jx, 0.5 + 1.0 * s, z + jz))
                mb.add_mesh(v, f, 3 + int(rng.integers(n_col_mats)), uv)
                placed += 1
    return assemble(mb.build(), albedo, emission, tex, textures,
                    camera([0.0, 3.0, hz * 0.95], [0.0, 2.0, 0.0], 55.0))

