"""Next-event-estimation light sampling (counterpart of
`blink.sampling.lights`): a point on an emissive triangle or sphere with
its area pdf.

Light-row layout (LIGHT_COLS = 16):
  0:3   a0    tri v0            | sphere center
  3:6   a1    tri v1            | sphere (radius, 0, 0)
  6:9   a2    tri v2            | unused
  9:12  n     tri unit normal   | unused (sphere normal is per-ray)
  12    pdf_area (1/area | 1/(4 pi r^2))
  13    kind (LIGHT_TRI | LIGHT_SPHERE)
  14    material id
  15    pad
"""
from __future__ import annotations

import math

import torch

from blink_torch.core import vec
from blink_torch.scene.scene import LIGHT_SPHERE, Scene

LIGHT_COLS = 16


def pack_light_rows(scene: Scene) -> torch.Tensor:
    """(L, 16) packed light table."""
    lights = scene.lights
    dev = scene.device
    l = lights.kind.shape[0]
    if l == 0:
        return torch.zeros((0, LIGHT_COLS), dtype=torch.float32, device=dev)
    kind = lights.kind
    prim = lights.prim.long()
    a0 = torch.zeros((l, 3), dtype=torch.float32, device=dev)
    a1 = torch.zeros_like(a0)
    a2 = torch.zeros_like(a0)
    n_l = torch.zeros_like(a0)
    pdf = torch.ones((l,), dtype=torch.float32, device=dev)
    mat = torch.zeros((l,), dtype=torch.int32, device=dev)

    if scene.n_triangles > 0:
        tris = scene.triangles
        tp = torch.clamp(prim, 0, scene.n_triangles - 1)
        i = tris.idx[tp].long()
        v0 = tris.verts[i[:, 0]]
        v1 = tris.verts[i[:, 1]]
        v2 = tris.verts[i[:, 2]]
        c = vec.cross(v1 - v0, v2 - v0)
        twice_area = vec.length(c)
        nt = c / torch.clamp(twice_area, min=vec.EPS)[..., None]
        pdf_t = 2.0 / torch.clamp(twice_area, min=vec.EPS)  # 1/area
        is_t = kind != LIGHT_SPHERE
        a0 = torch.where(is_t[:, None], v0, a0)
        a1 = torch.where(is_t[:, None], v1, a1)
        a2 = torch.where(is_t[:, None], v2, a2)
        n_l = torch.where(is_t[:, None], nt, n_l)
        pdf = torch.where(is_t, pdf_t, pdf)
        mat = torch.where(is_t, tris.material_id[tp], mat)

    if scene.n_spheres > 0:
        sp = torch.clamp(prim, 0, scene.n_spheres - 1)
        c = scene.spheres.center[sp]
        r = scene.spheres.radius[sp]
        pdf_s = 1.0 / (4.0 * math.pi * torch.clamp(r * r, min=vec.EPS))
        is_s = kind == LIGHT_SPHERE
        a0 = torch.where(is_s[:, None], c, a0)
        r3 = torch.cat([r[:, None], torch.zeros((l, 2), dtype=r.dtype, device=dev)], 1)
        a1 = torch.where(is_s[:, None], r3, a1)
        pdf = torch.where(is_s, pdf_s, pdf)
        mat = torch.where(is_s, scene.spheres.material_id[sp], mat)

    return torch.cat(
        [
            a0, a1, a2, n_l, pdf[:, None],
            kind.to(torch.float32)[:, None],
            mat.to(torch.float32)[:, None],
            torch.zeros((l, 1), dtype=torch.float32, device=dev),
        ],
        dim=1,
    )


def sample_light_point(scene: Scene, light, u1, u2, rows=None):
    """Sample a point on light index `light` ((N,) each).

    rows: optional precomputed pack_light_rows(scene). Returns (p, n_l,
    pdf_area, mat_id): the point (N, 3), the unit surface normal there
    (N, 3), the area-measure pdf (N,) and the light's material (N,) i32.
    """
    if rows is None:
        rows = pack_light_rows(scene)
    row = rows.index_select(0, light.long())
    a0 = row[:, 0:3]
    a1 = row[:, 3:6]
    a2 = row[:, 6:9]
    is_s = row[:, 13] == float(LIGHT_SPHERE)
    mat = row[:, 14].to(torch.int32)
    pdf = row[:, 12]

    # Triangle hypothesis: sqrt-warp barycentric sample.
    su = torch.sqrt(torch.clamp(u1, min=1e-12))
    b0 = 1.0 - su
    b1 = u2 * su
    pt = b0[:, None] * a0 + b1[:, None] * a1 + (1.0 - b0 - b1)[:, None] * a2
    nt = row[:, 9:12]

    # Sphere hypothesis: uniform area sample.
    z = 1.0 - 2.0 * u1
    phi = 2.0 * math.pi * u2
    s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    w = torch.stack([s * torch.cos(phi), s * torch.sin(phi), z], dim=-1)
    ps = a0 + a1[:, 0:1] * w

    sel = is_s[:, None]
    return torch.where(sel, ps, pt), torch.where(sel, w, nt), pdf, mat
