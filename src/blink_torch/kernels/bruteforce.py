"""Brute-force intersection of every ray with every primitive (counterpart
of `blink.kernels.bruteforce`): the `brute` backend, and the independent
oracle the wide walks and the sphere kernel are held against.

Plain torch on any device; memory is O(rays x primitives), so rays go in
batches. Outputs are integer topology: nothing here carries a gradient
(differentiable quantities come from diff.hitrefine).
"""
from __future__ import annotations

import torch

from blink_torch.kernels.sphere import sphere_t
from blink_torch.kernels.triangle import triangle_t
from blink_torch.kernels.types import KIND_NONE, KIND_SPHERE, KIND_TRI, T_MAX, T_MIN, Hit
from blink_torch.scene.scene import Scene

#: Ray-primitive tests per batch: bounds the (rays, primitives) scratch.
_BATCH_TESTS = 1 << 22


def _tri_soa(scene: Scene):
    """(v0, e1, e2) of every triangle, each (T, 3)."""
    tris = scene.triangles
    i = tris.idx.long()
    v0 = tris.verts[i[:, 0]]
    return v0, tris.verts[i[:, 1]] - v0, tris.verts[i[:, 2]] - v0


def _batches(n: int, prims: int):
    step = max(1, _BATCH_TESTS // max(prims, 1))
    for s in range(0, n, step):
        yield slice(s, min(n, s + step))


@torch.no_grad()
def intersect_brute(o, d, scene: Scene, t_min: float = T_MIN, t_max: float = T_MAX,
                    alive=None) -> Hit:
    """Closest hit over all primitives: spheres first, then triangles, each
    taking the first of tied minima. `alive`: dead lanes report the
    canonical miss (t = T_MAX, kind NONE, prim 0)."""
    n = o.shape[0]
    dev = o.device
    best_t = torch.full((n,), T_MAX, dtype=torch.float32, device=dev)
    kind = torch.full((n,), KIND_NONE, dtype=torch.int32, device=dev)
    prim = torch.zeros((n,), dtype=torch.int32, device=dev)
    tri = _tri_soa(scene) if scene.n_triangles > 0 else None
    sph = scene.spheres
    for sl in _batches(n, scene.n_spheres + scene.n_triangles):
        oo, dd = o[sl, None, :], d[sl, None, :]
        bt, bk, bp = best_t[sl], kind[sl], prim[sl]
        if scene.n_spheres > 0:
            ts = sphere_t(oo, dd, sph.center[None], sph.radius[None], t_min, t_max)
            s_t, s_prim = torch.min(ts, dim=1)
            upd = s_t < bt
            bt = torch.where(upd, s_t, bt)
            bk = torch.where(upd, KIND_SPHERE, bk)
            bp = torch.where(upd, s_prim.to(torch.int32), bp)
        if tri is not None:
            v0, e1, e2 = (x[None] for x in tri)
            ts = triangle_t(oo, dd, v0, e1, e2, t_min, t_max)
            tr_t, tr_prim = torch.min(ts, dim=1)
            upd = tr_t < bt
            bt = torch.where(upd, tr_t, bt)
            bk = torch.where(upd, KIND_TRI, bk)
            bp = torch.where(upd, tr_prim.to(torch.int32), bp)
        best_t[sl], kind[sl], prim[sl] = bt, bk, bp
    if alive is not None:
        best_t = torch.where(alive, best_t, T_MAX)
        kind = torch.where(alive, kind, KIND_NONE).to(torch.int32)
        prim = torch.where(alive, prim, 0)
    return Hit(t=best_t, kind=kind, prim=prim)


@torch.no_grad()
def occluded_brute(o, d, scene: Scene, t_far, t_min: float = T_MIN):
    """Any hit in [t_min, t_far] over all primitives: True where the segment
    is blocked."""
    n = o.shape[0]
    blocked = torch.zeros((n,), dtype=torch.bool, device=o.device)
    tri = _tri_soa(scene) if scene.n_triangles > 0 else None
    sph = scene.spheres
    for sl in _batches(n, scene.n_spheres + scene.n_triangles):
        oo, dd, tf = o[sl, None, :], d[sl, None, :], t_far[sl, None]
        b = blocked[sl]
        if scene.n_spheres > 0:
            ts = sphere_t(oo, dd, sph.center[None], sph.radius[None], t_min, tf)
            b = b | (ts < T_MAX).any(dim=1)
        if tri is not None:
            v0, e1, e2 = (x[None] for x in tri)
            ts = triangle_t(oo, dd, v0, e1, e2, t_min, tf)
            b = b | (ts < T_MAX).any(dim=1)
        blocked[sl] = b
    return blocked
