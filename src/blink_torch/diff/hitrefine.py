"""Differentiable hit refinement at fixed topology (counterpart of
`blink.diff.hitrefine`).

Traversal returns integer topology (kind, prim); this module re-derives
every shading quantity (t, point, normal, uv, material) in closed form from
(ray, prim, scene), so autograd gives exact geometry, material and camera
gradients at fixed hit topology.

Triangle attributes come in one of three modes:
  table  — static geometry: every attribute from one row of the packed
           shade table;
  hybrid — vertices swapped for parameters (scene.geom_dirty) and an f32
           table: uv and material from the table (no parameter changes
           them), v0/e1/e2 gathered live from the vertices;
  live   — no table: everything gathered live.

Per-ray gathers from a table that may carry a gradient use index_select,
whose backward is one index_add_. The backward of `table[idx]` sorts the
indices and adds each run of equal ones serially: with a million rays over
a few materials that took 96% of a fwd+bwd step on the H100 (PERF.md).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from blink_torch.core import vec
from blink_torch.kernels.sphere import sphere_t
from blink_torch.kernels.triangle import triangle_tuv
from blink_torch.kernels.types import KIND_SPHERE, KIND_TRI, T_MAX, T_MIN, Hit
from blink_torch.obs.profile import span
from blink_torch.scene.scene import Scene
from blink_torch.scene.textures import sample_texture


class _GatherTriVerts(torch.autograd.Function):
    """The three vertex rows of each hit triangle: verts (V, 3), i (N, 3)
    int64 -> three (N, 3). The backward is one index_add_ of the
    concatenated (3N, 3) rows into (V, 3)."""

    @staticmethod
    def forward(ctx, verts, i):
        ctx.save_for_backward(i)
        ctx.n_verts = verts.shape[0]
        return verts[i[:, 0]], verts[i[:, 1]], verts[i[:, 2]]

    @staticmethod
    def backward(ctx, g0, g1, g2):
        (i,) = ctx.saved_tensors
        with span("scatter_tri_verts"):
            idx = torch.cat([i[:, 0], i[:, 1], i[:, 2]])
            val = torch.cat([g0, g1, g2])
            out = torch.zeros((ctx.n_verts, 3), dtype=val.dtype, device=val.device)
            return out.index_add_(0, idx, val), None


@dataclasses.dataclass(frozen=True)
class HitGeom:
    """Per-ray shading geometry. All shapes (N, ...)."""

    valid: torch.Tensor  # (N,) bool — ray hit something
    t: torch.Tensor  # (N,) hit distance (T_MAX on miss)
    p: torch.Tensor  # (N,3) hit point
    n: torch.Tensor  # (N,3) unit normal, facing the incoming ray
    uv: torch.Tensor  # (N,2) texture coordinates
    mat: torch.Tensor  # (N,) i32 material id
    albedo: torch.Tensor  # (N,3) textured albedo
    emission: torch.Tensor  # (N,3) emitted radiance (two-sided)


def refine(o, d, hit: Hit, scene: Scene, shade: torch.Tensor | None) -> HitGeom:
    """Re-derive shading geometry from integer topology.

    o, d: (N,3) rays. shade: the (T,16) packed triangle table, or None
    (live mode). Misses give zeroed fields and valid=False.
    """
    with span("refine"):
        return _refine(o, d, hit, scene, shade)


def _refine(o, d, hit: Hit, scene: Scene, shade) -> HitGeom:
    n_rays = o.shape[0]
    dev = o.device
    prim = hit.prim.long()
    is_s = hit.kind == KIND_SPHERE
    is_t = hit.kind == KIND_TRI
    valid = is_s | is_t

    t = torch.full((n_rays,), T_MAX, dtype=torch.float32, device=dev)
    nrm = torch.zeros((n_rays, 3), dtype=torch.float32, device=dev)
    uv = torch.zeros((n_rays, 2), dtype=torch.float32, device=dev)
    mat = torch.zeros((n_rays,), dtype=torch.int32, device=dev)

    if scene.n_spheres > 0:
        sp = torch.clamp(prim, 0, scene.n_spheres - 1)
        c = scene.spheres.center.index_select(0, sp)
        r = scene.spheres.radius.index_select(0, sp)
        ts = sphere_t(o, d, c, r, T_MIN)  # same root selection as traversal
        ps = o + ts[:, None] * d
        ns = (ps - c) / torch.clamp(r, min=vec.EPS)[:, None]
        # Spherical uv (matches builders.icosphere parameterization).
        us = 0.5 + torch.atan2(ns[:, 2], ns[:, 0]) / (2.0 * math.pi)
        vs = 0.5 + torch.asin(torch.clamp(ns[:, 1], -1.0, 1.0)) / math.pi
        t = torch.where(is_s, ts, t)
        nrm = torch.where(is_s[:, None], ns, nrm)
        uv = torch.where(is_s[:, None], torch.stack([us, vs], -1), uv)
        mat = torch.where(is_s, scene.spheres.material_id[sp], mat)

    if scene.n_triangles > 0:
        tris = scene.triangles
        tp = torch.clamp(prim, 0, scene.n_triangles - 1)
        if shade is not None and not scene.geom_dirty:  # table
            row = shade.index_select(0, tp)
            v0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
            uv0, duv1, duv2 = row[:, 9:11], row[:, 11:13], row[:, 13:15]
            mat_t = row[:, 15].to(torch.int32)
        else:
            i = tris.idx[tp].long()
            v0, v1, v2 = _GatherTriVerts.apply(tris.verts, i)
            e1, e2 = v1 - v0, v2 - v0
            # An f64 scene skips the hybrid: the f32 table would truncate uv.
            if shade is not None and tris.verts.dtype == torch.float32:  # hybrid
                row = shade.index_select(0, tp)
                uv0, duv1, duv2 = row[:, 9:11], row[:, 11:13], row[:, 13:15]
                mat_t = row[:, 15].to(torch.int32)
            else:  # live
                uv0 = tris.uv[i[:, 0]]
                duv1 = tris.uv[i[:, 1]] - uv0
                duv2 = tris.uv[i[:, 2]] - uv0
                mat_t = tris.material_id[tp]
        tt, bu, bv = triangle_tuv(o, d, v0, e1, e2, T_MIN)
        ng = vec.normalize(vec.cross(e1, e2))
        uv_tri = uv0 + bu[:, None] * duv1 + bv[:, None] * duv2
        t = torch.where(is_t, tt, t)
        nrm = torch.where(is_t[:, None], ng, nrm)
        uv = torch.where(is_t[:, None], uv_tri, uv)
        mat = torch.where(is_t, mat_t, mat)

    # Refinement disagreeing with traversal (measure-zero edge) is a miss.
    valid = valid & (t < T_MAX)
    t_safe = torch.where(valid, t, 0.0)
    p = o + t_safe[:, None] * d
    # Face the normal against the incoming direction (two-sided shading).
    flip = torch.where(vec.vdot(nrm, d) > 0.0, -1.0, 1.0)
    nrm = nrm * flip[:, None]

    m = scene.materials
    ml = mat.long()
    tex = sample_texture(scene.textures, m.texture_id[ml], uv)
    albedo = m.albedo.index_select(0, ml) * tex
    emission = m.emission.index_select(0, ml)
    vmask = valid[:, None]
    return HitGeom(
        valid=valid,
        t=torch.where(valid, t, T_MAX),
        p=torch.where(vmask, p, 0.0),
        n=torch.where(vmask, nrm, 0.0),
        uv=torch.where(vmask, uv, 0.0),
        mat=torch.where(valid, mat, 0),
        albedo=torch.where(vmask, albedo, 0.0),
        emission=torch.where(vmask, emission, 0.0),
    )
