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
"""
from __future__ import annotations

import numpy as np

from blink_torch.scene.scene import Triangles

SHADE_COLS = 16


def pack_tri_shade_np(tris: Triangles) -> np.ndarray:
    """(T, 16) float32 shading table, built on the host with numpy."""
    idx = tris.idx.cpu().numpy()
    verts = tris.verts.cpu().numpy()
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
