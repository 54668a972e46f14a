"""Packed per-triangle shading table (counterpart of `blink.scene.shade`).

Column layout (SHADE_COLS = 16):
  0:3   v0        triangle base vertex
  3:6   e1 = v1 - v0
  6:9   e2 = v2 - v0
  9:11  uv0
  11:13 duv1 = uv1 - uv0
  13:15 duv2 = uv2 - uv0
  15    material id (exact in f32 for ids < 2^24)

diff.hitrefine reads every attribute of a hit triangle from one row.

Two producers: `pack_tri_shade`, in torch and differentiable with respect
to the vertices and uvs (render_image builds it in the graph when a
backend has no table and the geometry is static), and `pack_tri_shade_np`,
built once on the host by make_backend.
"""
from __future__ import annotations

import numpy as np
import torch

from blink_torch.scene.scene import Triangles

SHADE_COLS = 16


def pack_tri_shade(tris: Triangles) -> torch.Tensor:
    """(T, 16) shading table in torch, on the triangles' device."""
    if tris.idx.shape[0] == 0:
        return torch.zeros((0, SHADE_COLS), dtype=tris.verts.dtype,
                           device=tris.verts.device)
    i = tris.idx.long()
    v0 = tris.verts[i[:, 0]]
    e1 = tris.verts[i[:, 1]] - v0
    e2 = tris.verts[i[:, 2]] - v0
    uv0 = tris.uv[i[:, 0]]
    duv1 = tris.uv[i[:, 1]] - uv0
    duv2 = tris.uv[i[:, 2]] - uv0
    mat = tris.material_id.to(tris.verts.dtype)[:, None]
    return torch.cat([v0, e1, e2, uv0, duv1, duv2, mat], dim=1)


def pack_tri_shade_np(tris: Triangles) -> np.ndarray:
    """(T, 16) float32 shading table, built on the host with numpy."""
    idx = tris.idx.cpu().numpy()
    verts = tris.verts.detach().cpu().numpy()
    if idx.shape[0] == 0:
        return np.zeros((0, SHADE_COLS), verts.dtype)
    uv = tris.uv.cpu().numpy()
    v0 = verts[idx[:, 0]]
    e1 = verts[idx[:, 1]] - v0
    e2 = verts[idx[:, 2]] - v0
    uv0 = uv[idx[:, 0]]
    duv1 = uv[idx[:, 1]] - uv0
    duv2 = uv[idx[:, 2]] - uv0
    mat = tris.material_id.cpu().numpy().astype(verts.dtype)[:, None]
    return np.concatenate([v0, e1, e2, uv0, duv1, duv2, mat], axis=1)
