"""CPU reference renderer: an independent numpy implementation of the
deterministic direct-lighting estimator (counterpart of
`blink.ref.renderer`, line for line).

It shares no code with the torch path or the CUDA kernels, only the Scene
data structures, so golden-image agreement (atol 1e-4) between this and
the port's render is evidence of semantic correctness, not of shared bugs.
It needs no JAX and no card, so it also serves as the oracle on the card's
machine. It mirrors, by specification:
  - pinhole camera with center-of-pixel rays (deterministic mode),
  - brute-force closest-hit over spheres + triangles,
  - two-sided Lambertian shading with per-light centroid NEE samples
    (u1 = 4/9, u2 = 1/2 — integrators.DET_U1/DET_U2),
  - shadow-ray occlusion with the same epsilons (RAY_EPS, T_MIN).
"""
from __future__ import annotations

import numpy as np

from blink_torch.scene.scene import LIGHT_SPHERE, Scene

T_MAX = 1e30
T_MIN = 1e-3
RAY_EPS = 1e-3
DET_U1 = 4.0 / 9.0
DET_U2 = 0.5


def _np(x, dtype=None) -> np.ndarray:
    """A tensor on any device as host numpy (`dtype`: converted exactly)."""
    a = x.detach().cpu().numpy()
    return a if dtype is None else a.astype(dtype)


def _np_scene(scene: Scene):
    """Pull scene arrays to host numpy once."""
    s = {
        "sc": _np(scene.spheres.center, np.float64),
        "sr": _np(scene.spheres.radius, np.float64),
        "sm": _np(scene.spheres.material_id),
        "tv": _np(scene.triangles.verts, np.float64),
        "ti": _np(scene.triangles.idx),
        "tm": _np(scene.triangles.material_id),
        "alb": _np(scene.materials.albedo, np.float64),
        "emi": _np(scene.materials.emission, np.float64),
        "lk": _np(scene.lights.kind),
        "lp": _np(scene.lights.prim),
    }
    return s


def _hit_spheres(o, d, sc, sr, t_min, t_max):
    """Vector over spheres for a single ray. Returns (t_best, idx)."""
    if sc.shape[0] == 0:
        return T_MAX, -1
    oc = o[None, :] - sc
    a = float(d @ d)
    half_b = oc @ d
    c = np.sum(oc * oc, axis=-1) - sr * sr
    disc = half_b * half_b - a * c
    sq = np.sqrt(np.maximum(disc, 0.0))
    t0 = (-half_b - sq) / a
    t1 = (-half_b + sq) / a
    t = np.where(t0 >= t_min, t0, t1)
    valid = (disc > 0) & (t >= t_min) & (t <= t_max)
    t = np.where(valid, t, T_MAX)
    i = int(np.argmin(t))
    return float(t[i]), (i if t[i] < T_MAX else -1)


def _hit_tris(o, d, v0, e1, e2, t_min, t_max):
    """Vector over triangles for a single ray. Returns (t_best, idx)."""
    if v0.shape[0] == 0:
        return T_MAX, -1
    pvec = np.cross(np.broadcast_to(d, e2.shape), e2)
    det = np.sum(e1 * pvec, axis=-1)
    # Exact 1/det guarded only against 0, as kernels.triangle (a
    # regularized inverse corrupts small-determinant hits).
    degenerate = det == 0.0
    inv_det = 1.0 / np.where(degenerate, 1.0, det)
    tvec = o[None, :] - v0
    u = np.sum(tvec * pvec, axis=-1) * inv_det
    qvec = np.cross(tvec, e1)
    v = np.sum(d[None, :] * qvec, axis=-1) * inv_det
    t = np.sum(e2 * qvec, axis=-1) * inv_det
    valid = (
        ~degenerate
        & (u >= 0)
        & (v >= 0)
        & (u + v <= 1)
        & (t >= t_min)
        & (t <= t_max)
    )
    t = np.where(valid, t, T_MAX)
    i = int(np.argmin(t))
    return float(t[i]), (i if t[i] < T_MAX else -1)


def _occluded(o, d, t_far, s, tri_soa):
    v0, e1, e2 = tri_soa
    t, i = _hit_spheres(o, d, s["sc"], s["sr"], T_MIN, t_far)
    if i >= 0:
        return True
    t, i = _hit_tris(o, d, v0, e1, e2, T_MIN, t_far)
    return i >= 0


def ref_render(scene: Scene, width: int, height: int) -> np.ndarray:
    """Deterministic direct-lighting render, (H, W, 3) float32."""
    s = _np_scene(scene)
    v0 = s["tv"][s["ti"][:, 0]] if s["ti"].shape[0] else np.zeros((0, 3))
    e1 = (s["tv"][s["ti"][:, 1]] - v0) if s["ti"].shape[0] else np.zeros((0, 3))
    e2 = (s["tv"][s["ti"][:, 2]] - v0) if s["ti"].shape[0] else np.zeros((0, 3))
    tri_soa = (v0, e1, e2)

    cam_o = _np(scene.camera.origin, np.float64)
    look = _np(scene.camera.look_at, np.float64)
    up_in = _np(scene.camera.up, np.float64)
    fov = float(scene.camera.fov_deg)
    fwd = look - cam_o
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, up_in)
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    half_h = np.tan(np.deg2rad(fov) * 0.5)
    aspect = width / height

    # Precompute light sample points (centroid rule).
    lights = []
    for li in range(s["lk"].shape[0]):
        kind, prim = int(s["lk"][li]), int(s["lp"][li])
        if kind == LIGHT_SPHERE:
            c, r = s["sc"][prim], float(s["sr"][prim])
            z = 1.0 - 2.0 * DET_U1
            phi = 2.0 * np.pi * DET_U2
            sn = np.sqrt(max(1.0 - z * z, 0.0))
            w = np.array([sn * np.cos(phi), sn * np.sin(phi), z])
            p_l = c + r * w
            n_l = w
            pdf = 1.0 / (4.0 * np.pi * max(r * r, 1e-6))
            mat = int(s["sm"][prim])
        else:
            a, b, c3 = (
                s["tv"][s["ti"][prim, 0]],
                s["tv"][s["ti"][prim, 1]],
                s["tv"][s["ti"][prim, 2]],
            )
            su = np.sqrt(DET_U1)
            b0 = 1.0 - su
            b1 = DET_U2 * su
            p_l = b0 * a + b1 * b + (1.0 - b0 - b1) * c3
            cr = np.cross(b - a, c3 - a)
            twice_area = np.linalg.norm(cr)
            n_l = cr / max(twice_area, 1e-6)
            pdf = 2.0 / max(twice_area, 1e-6)
            mat = int(s["tm"][prim])
        lights.append((p_l, n_l, pdf, mat))

    img = np.zeros((height, width, 3), np.float64)
    for i in range(height):
        for j in range(width):
            ndc_x = ((j + 0.5) / width * 2.0 - 1.0) * half_h * aspect
            ndc_y = (1.0 - (i + 0.5) / height * 2.0) * half_h
            d = fwd + ndc_x * right + ndc_y * up
            d /= np.linalg.norm(d)
            ts, si = _hit_spheres(cam_o, d, s["sc"], s["sr"], T_MIN, T_MAX)
            tt, ti_ = _hit_tris(cam_o, d, *tri_soa, T_MIN, T_MAX)
            if si < 0 and ti_ < 0:
                continue
            if ts < tt:
                t = ts
                p = cam_o + t * d
                n = (p - s["sc"][si]) / max(float(s["sr"][si]), 1e-6)
                mat = int(s["sm"][si])
            else:
                t = tt
                p = cam_o + t * d
                cr = np.cross(e1[ti_], e2[ti_])
                n = cr / max(np.linalg.norm(cr), 1e-6)
                mat = int(s["tm"][ti_])
            if n @ d > 0:
                n = -n
            alb = s["alb"][mat]
            out = s["emi"][mat].copy()
            shadow_o = p + n * RAY_EPS
            for p_l, n_l, pdf, lmat in lights:
                to_l = p_l - p
                dist2 = float(to_l @ to_l)
                dist = np.sqrt(max(dist2, 1e-12))
                wi = to_l / dist
                cos_s = max(float(n @ wi), 0.0)
                cos_l = abs(float(n_l @ wi))
                if cos_s <= 0.0 or cos_l <= 0.0:
                    continue
                if _occluded(shadow_o, wi, dist * (1.0 - 1e-3), s, tri_soa):
                    continue
                geom_term = cos_s * cos_l / max(dist2, 1e-8)
                out = out + alb / np.pi * s["emi"][lmat] * geom_term / max(pdf, 1e-6)
            img[i, j] = out
    return img.astype(np.float32)
