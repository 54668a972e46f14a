"""Soft-visibility gradients for silhouettes, of spheres and of meshes
(counterpart of `blink.diff.soft`).

Fixed-topology differentiation (diff.hitrefine) is exact for shading but
has no visibility-edge terms, and those dominate the pixel MSE when the
parameters are geometry positions (config 3). The remedy is SoftRas-style
soft coverage, written `hard + (soft - soft.detach())`: the image is the
hard render exactly, while the gradient is the soft estimator's.

Spheres: the ray-sphere discriminant is smooth in centre and radius and
crosses zero at the silhouette; alpha = sigmoid(disc / (sigma r^2)). It is
an (N, S) torch expression, not the sphere kernel, because it needs
gradients in `center` and `radius`; hard hits and shadow rays still go
through the backend.

Meshes (SoftRas-lite): a pixel's candidates are the hit triangles of the
pixel and of its 4 image neighbours. Each one's coverage is a sigmoid of
its barycentric edge margin in world units over the pixel footprint;
candidates composite front to back by plane-hit t with transmittance
weights.
"""
from __future__ import annotations

import math

import torch

from blink_torch.core import vec
from blink_torch.diff.hitrefine import HitGeom
from blink_torch.kernels.types import KIND_TRI
from blink_torch.obs.profile import span
from blink_torch.render.integrators import RAY_EPS, li_direct, nee_direct
from blink_torch.scene.scene import Scene, empty_spheres
from blink_torch.scene.textures import sample_texture

#: Relative depth tolerance of the conditional opaque background: candidate
#: layers whose plane hits all lie within this fraction of the nearest one
#: count as one surface (an interior edge, adjacent facets) and composite
#: against an opaque far layer; larger gaps are silhouettes and keep the
#: black background (_mesh_soft_radiance's opaque_last).
OPAQUE_T_REL = 0.08

#: t of a candidate that is not there (deduplicated, invalid or degenerate).
_NO_T = 1e30


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[rows, idx[rows]] for (N, K) x and (N,) idx; gradients flow to x."""
    return torch.gather(x, 1, idx[:, None]).squeeze(1)


def _sphere_soft_terms(o, d, scene: Scene, sigma: float):
    """Per-ray soft coverage of the nearest relevant sphere: (alpha (N,),
    t_star (N,), idx (N,) i32), alpha differentiable, t_star the real near
    root where the discriminant is positive and the closest approach
    otherwise."""
    c = scene.spheres.center  # (S, 3)
    r = scene.spheres.radius  # (S,)
    oc = o[:, None, :] - c[None, :, :]  # (N, S, 3)
    a = vec.vdot(d, d)[:, None]  # (N, 1)
    half_b = vec.vdot(oc, d[:, None, :])  # (N, S)
    cc = vec.vdot(oc, oc) - (r * r)[None, :]
    disc = half_b * half_b - a * cc  # smooth in c and r
    alpha = torch.sigmoid(disc / (sigma * (r * r)[None, :]))

    sq = torch.sqrt(torch.where(disc > 0, disc, 1.0))
    t_hit = torch.where(disc > 0, (-half_b - sq) / a, -half_b / a)
    # The nearest sphere in front with non-negligible coverage; the first
    # of tied minima, as jnp.argmin.
    relevant = (alpha > 1e-3) & (t_hit > RAY_EPS)
    t_sort = torch.where(relevant, t_hit, _NO_T)
    idx = torch.argmin(t_sort, dim=1)
    alpha_sel = torch.where(_take(relevant, idx), _take(alpha, idx), 0.0)
    return alpha_sel, _take(t_hit, idx), idx.to(torch.int32)


def _sphere_geom(o, d, scene: Scene, t_star, idx, valid) -> HitGeom:
    """Differentiable shading geometry on sphere `idx` at t_star (the real
    hit, or the closest approach projected onto the surface)."""
    i = idx.long()
    c = scene.spheres.center.index_select(0, i)
    r = scene.spheres.radius.index_select(0, i)
    p_line = o + t_star[:, None] * d
    nrm = vec.normalize(p_line - c)
    p = c + nrm * r[:, None]  # onto the surface (the silhouette's limit)
    mat = scene.spheres.material_id[i]
    ml = mat.long()
    albedo = scene.materials.albedo.index_select(0, ml)
    emission = scene.materials.emission.index_select(0, ml)
    vmask = valid[:, None]
    u = 0.5 + torch.atan2(nrm[..., 2], nrm[..., 0]) / (2.0 * math.pi)
    v = 0.5 + torch.asin(torch.clamp(nrm[..., 1], -1.0, 1.0)) / math.pi
    return HitGeom(
        valid=valid,
        t=torch.where(valid, t_star, _NO_T),
        p=torch.where(vmask, p, 0.0),
        n=torch.where(vmask, nrm, 0.0),
        uv=torch.where(vmask, torch.stack([u, v], -1), 0.0),
        mat=torch.where(valid, mat, 0),
        albedo=torch.where(vmask, albedo, 0.0),
        emission=torch.where(vmask, emission, 0.0),
    )


def _tri_corners(scene: Scene, prim):
    """(prim, i0, i1, i2, v0, e1, e2) of triangle `prim` (N,), clamped into
    range; the vertices gathered with index_select."""
    tris = scene.triangles
    tp = torch.clamp(prim.long(), 0, scene.n_triangles - 1)
    i = tris.idx[tp].long()
    i0, i1, i2 = i[:, 0], i[:, 1], i[:, 2]
    v0 = tris.verts.index_select(0, i0)
    e1 = tris.verts.index_select(0, i1) - v0
    e2 = tris.verts.index_select(0, i2) - v0
    return tp, i0, i1, i2, v0, e1, e2


def _tri_geom(o, d, scene: Scene, prim, t_plane, valid) -> HitGeom:
    """Differentiable shading geometry on triangle `prim` at its plane hit
    (a near miss shades at the limit point just outside the edge)."""
    tris = scene.triangles
    tp, i0, i1, i2, v0, e1, e2 = _tri_corners(scene, prim)
    nrm = vec.normalize(vec.cross(e1, e2))
    p = o + t_plane[:, None] * d
    # Barycentrics of the plane point (uv and texture continuity).
    pvec = vec.cross(d, e2)
    det = vec.vdot(e1, pvec)
    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
    tvec = o - v0
    u = vec.vdot(tvec, pvec) * inv_det
    qvec = vec.cross(tvec, e1)
    v = vec.vdot(d, qvec) * inv_det
    uv = (
        (1.0 - u - v)[:, None] * tris.uv.index_select(0, i0)
        + u[:, None] * tris.uv.index_select(0, i1)
        + v[:, None] * tris.uv.index_select(0, i2)
    )
    flip = torch.where(vec.vdot(nrm, d) > 0.0, -1.0, 1.0)
    nrm = nrm * flip[:, None]
    mat = tris.material_id[tp]
    m = scene.materials
    ml = mat.long()
    tex = sample_texture(scene.textures, m.texture_id[ml], uv)
    albedo = m.albedo.index_select(0, ml) * tex
    emission = m.emission.index_select(0, ml)
    vmask = valid[:, None]
    return HitGeom(
        valid=valid,
        t=torch.where(valid, t_plane, _NO_T),
        p=torch.where(vmask, p, 0.0),
        n=torch.where(vmask, nrm, 0.0),
        uv=torch.where(vmask, uv, 0.0),
        mat=torch.where(valid, mat, 0),
        albedo=torch.where(vmask, albedo, 0.0),
        emission=torch.where(vmask, emission, 0.0),
    )


def _mesh_soft_radiance(o, d, keys, scene: Scene, backend, deterministic: bool,
                        sigma: float, hw: tuple[int, int], hit,
                        residual_radiance: torch.Tensor | None = None,
                        opaque_last: bool = True) -> torch.Tensor:
    """SoftRas-lite radiance over the neighbour-candidate triangles.

    hit: the hard topology (backend.intersect's Hit). Rays MUST be in
    row-major (h, w) pixel order; the neighbours wrap at the image border.
    `sigma` is the silhouette band's half-width in pixels.

    residual_radiance: what the transmittance left after every candidate
    layer sees (pass the ray's hard radiance); None: the black
    environment. opaque_last: where every valid candidate lies at nearly
    one depth (OPAQUE_T_REL), the furthest valid layer is made opaque, so
    an interior edge reconstructs exactly; silhouettes keep the black
    background."""
    h, w = hw
    n = o.shape[0]
    # Vertical pixel angle of the pinhole, 2 tan(fov/2) / h: a scale, not
    # a differentiation surface.
    pix_ang = (2.0 * torch.tan(scene.camera.fov_deg * (math.pi / 180.0) * 0.5) / h).detach()
    prim = torch.where(hit.kind == KIND_TRI, hit.prim, -1)
    pimg = prim.reshape(h, w)
    # Candidates: the own hit and the 4 neighbours' (deduplicated in order).
    cands = [pimg, torch.roll(pimg, 1, 0), torch.roll(pimg, -1, 0),
             torch.roll(pimg, 1, 1), torch.roll(pimg, -1, 1)]
    cands = [c.reshape(n) for c in cands]
    dedup = [cands[0]]
    for c in cands[1:]:
        dup = torch.zeros((n,), dtype=torch.bool, device=o.device)
        for seen in dedup:
            dup = dup | (c == seen)
        dedup.append(torch.where(dup, -1, c))

    alphas, ts = [], []
    for c in dedup:
        _, _, _, _, v0, e1, e2 = _tri_corners(scene, c)
        # Raw (uncut) Möller–Trumbore: the smooth plane hit and barycentrics.
        pvec = vec.cross(d, e2)
        det = vec.vdot(e1, pvec)
        degenerate = det == 0.0
        inv_det = 1.0 / torch.where(degenerate, 1.0, det)
        tvec = o - v0
        u = vec.vdot(tvec, pvec) * inv_det
        qvec = vec.cross(tvec, e1)
        v = vec.vdot(d, qvec) * inv_det
        t_pl = vec.vdot(e2, qvec) * inv_det
        # Signed edge distance in world units (barycentric times the
        # opposite edge's height) over the pixel footprint at the hit
        # distance: the sigmoid band is `sigma` pixels wide on screen,
        # whatever the triangle's size or distance.
        n2 = vec.cross(e1, e2)
        area2 = torch.sqrt(torch.clamp(vec.vdot(n2, n2), min=1e-20))
        h_u = area2 / torch.clamp(torch.linalg.vector_norm(e2, dim=-1), min=1e-10)
        h_v = area2 / torch.clamp(torch.linalg.vector_norm(e1, dim=-1), min=1e-10)
        h_w = area2 / torch.clamp(torch.linalg.vector_norm(e2 - e1, dim=-1), min=1e-10)
        d_world = torch.minimum(torch.minimum(u * h_u, v * h_v), (1.0 - u - v) * h_w)
        footprint = torch.clamp(t_pl, min=RAY_EPS) * pix_ang
        alpha = torch.sigmoid(d_world / (sigma * footprint))
        ok = (c >= 0) & ~degenerate & (t_pl > RAY_EPS)
        alphas.append(torch.where(ok, alpha, 0.0))
        ts.append(torch.where(ok, t_pl, _NO_T))
    A = torch.stack(alphas, dim=1)  # (N, 5)
    T = torch.stack(ts, dim=1)
    Pr = torch.stack(dedup, dim=1)
    # Front to back; jnp.argsort is stable, so ties (the 1e30s) keep
    # candidate order.
    order = torch.argsort(T, dim=1, stable=True)
    A = torch.gather(A, 1, order)
    T = torch.gather(T, 1, order)
    Pr = torch.gather(Pr, 1, order)
    k_all = len(dedup)
    if opaque_last:
        valid = T < 1e29
        nvalid = valid.to(torch.int32).sum(dim=1)
        kidx = torch.arange(k_all, device=o.device)[None, :]
        is_last = (kidx == (nvalid - 1)[:, None]) & valid
        t_first = T[:, 0]
        t_last = torch.where(is_last, T, 0.0).sum(dim=1)
        coplanar = (nvalid > 1) & (t_last <= t_first * (1.0 + OPAQUE_T_REL) + RAY_EPS)
        A = torch.where(is_last & coplanar[:, None], 1.0, A)

    soft = torch.zeros((n, 3), dtype=A.dtype, device=o.device)
    trans = torch.ones((n,), dtype=A.dtype, device=o.device)
    for k in range(k_all):
        geom = _tri_geom(o, d, scene, Pr[:, k], T[:, k], (A[:, k] > 0.0) & (T[:, k] < 1e29))
        l_k = geom.emission + nee_direct(scene, geom, keys, backend, bounce=0,
                                         deterministic=deterministic)
        soft = soft + (trans * A[:, k])[:, None] * l_k
        trans = trans * (1.0 - A[:, k])
    if residual_radiance is not None:
        soft = soft + trans[:, None] * residual_radiance
    return soft


def li_direct_soft(o, d, keys, scene: Scene, backend, deterministic: bool, sigma: float,
                   hw: tuple[int, int] | None = None) -> torch.Tensor:
    """Direct-lighting radiance with soft-silhouette gradients.

    The value is li_direct's exactly (hard + soft - soft.detach()); the
    backward flows through the soft coverage blends. Sphere silhouettes
    always; mesh silhouettes when `hw` gives the image shape (rays in
    row-major pixel order)."""
    hard = li_direct(o, d, keys, scene, backend, deterministic)
    out = hard
    if scene.n_spheres > 0:
        with span("soft"):
            # Background: the scene without spheres; the backend built for
            # the whole scene serves it (its chunks hold triangles only).
            scene_bg = scene.replace(spheres=empty_spheres().to(scene.device))
            l_bg = li_direct(o, d, keys, scene_bg, backend, deterministic)
            alpha, t_star, idx = _sphere_soft_terms(o, d, scene, sigma)
            geom = _sphere_geom(o, d, scene, t_star, idx, alpha > 0.0)
            l_sph = geom.emission + nee_direct(scene, geom, keys, backend, bounce=0,
                                               deterministic=deterministic)
            soft = alpha[:, None] * l_sph + (1.0 - alpha[:, None]) * l_bg
            out = out + (soft - soft.detach())
    if hw is not None and scene.n_triangles > 0:
        with span("soft"):
            # A geometry-gradient estimator (tri_verts silhouettes): the
            # camera is detached out of it. Camera gradients flow through
            # the hard estimator's shading terms and the sphere-soft term.
            o_m, d_m = o.detach(), d.detach()
            hit = backend.intersect(o_m, d_m, scene)
            soft_m = _mesh_soft_radiance(o_m, d_m, keys, scene, backend, deterministic,
                                         sigma, hw, hit, residual_radiance=None,
                                         opaque_last=False)
            out = out + (soft_m - soft_m.detach())
    return out
