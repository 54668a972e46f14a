"""The plain PyTorch reference that decides `correct`.

It renders what the program renders, from the same scene arrays, with the
same counter-based random streams, and imports nothing of the program:
the camera, the sampler, texture lookup, hit refinement, light sampling,
the direct and path integrators and the soft mesh silhouettes are a frozen
copy of the port's plain torch arithmetic (so that the same inputs round
the same way), and the traversal is its own: a Morton-ordered binary BVH
built here on the device, walked with a stack per ray. Its triangle test
is the port's Möller–Trumbore, operation for operation, so it finds the
same hits but for exact ties in t.

Scope: triangle scenes with triangle lights (both configurations have no
spheres). Every float tensor is computed in `dtype`: float32 is the
reference, bfloat16 the control that must fail the comparison.
"""
from __future__ import annotations

import math

import torch

T_MAX = 1e30
T_MIN = 1e-3
RAY_EPS = 1e-3
EPS = 1e-6
INV_PI = 1.0 / math.pi
DET_U1 = 4.0 / 9.0
DET_U2 = 0.5
_NO_T = 1e30


# --------------------------------------------------------------------------
# 3-vectors, written out left to right as the port rounds them.
# --------------------------------------------------------------------------


def vdot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], -1)


def length(a):
    return torch.sqrt(vdot(a, a))


def normalize(a, eps: float = EPS):
    return a / torch.clamp(length(a), min=eps)[..., None]


def make_onb(n):
    z = n[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + z)
    b = n[..., 0] * n[..., 1] * a
    t0 = torch.stack([1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]], -1)
    t1 = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], -1)
    return t0, t1, n


# --------------------------------------------------------------------------
# Counter-based random streams (int64 words holding uint32 values).
# --------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_GOLDEN2 = 0x517CC1B7
_BLOCK_NS = 0xB10C_B10C
_DIM_STRIDE = 16


def _mul(x, c: int):
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(x):
    x = x ^ (x >> 16)
    x = _mul(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul(x, 0x846CA68B)
    return x ^ (x >> 16)


def _mix2(x):
    x = x ^ (x >> 16)
    x = _mul(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def fold(key, data):
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    lo = _mix(key[..., 0] ^ ((_mul(d, _GOLDEN) + 0x85EBCA6B) & _M32))
    hi = _mix2(key[..., 1] ^ ((_mul(d, _GOLDEN2) + 0x27220A95) & _M32) ^ lo)
    lo, hi = torch.broadcast_tensors(lo, hi)
    return torch.stack([lo, hi], dim=-1)


def seed_key(seed: int, device):
    acc = torch.zeros(2, dtype=torch.int64, device=device)
    for word in ((seed >> 32) & _M32, seed & _M32):
        acc = fold(acc, word)
    return acc


def uniform(key, n: int, dim: int, dtype):
    ctr = dim * _DIM_STRIDE + torch.arange(n, device=key.device)
    h = fold(key[..., None, :], ctr)[..., 1]
    return ((h >> 8).to(torch.float32) * (1.0 / (1 << 24))).to(dtype)


# --------------------------------------------------------------------------
# The scene on the device.
# --------------------------------------------------------------------------


class Scene:
    """Tensors of a scene dict (lib/scenes.py) on `device` in `dtype`;
    `verts`, `albedo` and `emission` may be swapped for parameters."""

    def __init__(self, arrays: dict, device, dtype=torch.float32):
        t, m, c = arrays["triangles"], arrays["materials"], arrays["camera"]
        if len(arrays["spheres"]["radius"]) or (arrays["lights"]["kind"] != 0).any():
            raise ValueError("the reference renders triangle scenes with triangle lights")

        def f(a):
            return torch.as_tensor(a).to(device=device, dtype=dtype)

        def i(a):
            return torch.as_tensor(a).to(device=device, dtype=torch.int64)

        self.device, self.dtype = torch.device(device), dtype
        self.verts, self.idx, self.uv, self.tri_mat = (
            f(t["verts"]), i(t["idx"]), f(t["uv"]), i(t["material_id"]))
        self.albedo, self.emission, self.tex_id = f(m["albedo"]), f(m["emission"]), i(m["texture_id"])
        self.textures = f(arrays["textures"])
        self.light_prim = i(arrays["lights"]["prim"])
        self.cam = {k: f(v) for k, v in c.items()}

    def params(self, names) -> dict:
        """Leaf copies of the named parameters, swapped into the scene."""
        out = {}
        for n in names:
            attr = {"tri_verts": "verts", "albedo": "albedo", "emission": "emission"}[n]
            p = getattr(self, attr).detach().clone().requires_grad_(True)
            setattr(self, attr, p)
            out[n] = p
        return out


# --------------------------------------------------------------------------
# Traversal: a Morton-ordered binary BVH over leaves of LEAF triangles, as a
# complete tree in heap order (root 1, children 2i and 2i + 1, leaves at
# [P, 2P)).
# --------------------------------------------------------------------------

LEAF = 4
_STACK = 64
#: A triangle whose box spans more than this share of the scene's extent
#: is tested against every ray instead of sitting in the tree, where it
#: would widen every box above it (a hall's floor and walls).
BIG_SHARE = 1.0 / 64
_BIG_MAX = 256


class BVH:
    def __init__(self, scene: Scene):
        dt = scene.dtype
        v = scene.verts.detach()
        i = scene.idx
        v0, v1, v2 = v[i[:, 0]], v[i[:, 1]], v[i[:, 2]]
        self.v0, self.e1, self.e2 = v0, v1 - v0, v2 - v0
        lo = torch.minimum(torch.minimum(v0, v1), v2).float()
        hi = torch.maximum(torch.maximum(v0, v1), v2).float()
        smin, smax = lo.amin(0), hi.amax(0)
        extent = float((smax - smin).max())
        span = (hi - lo).amax(1)
        nbig = min(_BIG_MAX, int((span > BIG_SHARE * extent).sum()))
        order_span = torch.argsort(span, descending=True)
        self.big = order_span[:nbig]
        small = order_span[nbig:]
        cen = 0.5 * (lo[small] + hi[small])
        q = ((cen - smin) / max(extent, 1e-12) * 1023).long().clamp(0, 1023)
        code = torch.zeros_like(q[:, 0])
        for b in range(10):
            for a in range(3):
                code |= ((q[:, a] >> b) & 1) << (3 * b + a)
        order = small[torch.argsort(code)]
        n = order.numel()
        nleaf = max(1, -(-n // LEAF))
        self.P = P = 1 << max(0, (nleaf - 1).bit_length())
        tri = torch.full((P * LEAF,), -1, dtype=torch.int64, device=v.device)
        tri[:n] = order
        self.leaf_tri = tri.view(P, LEAF)
        # Boxes padded outward so that rounding in the slab test never
        # drops a triangle the exact test would hit.
        pad = 1e-5 * extent + 1e-6
        big = torch.full((P * LEAF, 3), float("inf"), device=v.device)
        tlo, thi = big.clone(), -big
        tlo[:n], thi[:n] = lo[order] - pad, hi[order] + pad
        node_lo = torch.empty((2 * P, 3), device=v.device)
        node_hi = torch.empty((2 * P, 3), device=v.device)
        node_lo[P:] = tlo.view(P, LEAF, 3).amin(1)
        node_hi[P:] = thi.view(P, LEAF, 3).amax(1)
        k = P
        while k > 1:
            node_lo[k // 2:k] = torch.minimum(node_lo[k:2 * k:2], node_lo[k + 1:2 * k:2])
            node_hi[k // 2:k] = torch.maximum(node_hi[k:2 * k:2], node_hi[k + 1:2 * k:2])
            k //= 2
        self.lo, self.hi = node_lo.to(dt), node_hi.to(dt)
        self.full = (node_lo <= node_hi).all(1)  # False: a box of padding only
        self.dtype = dt


def _slab(o, ix, t_min, t_max, lo, hi):
    """(M, K) passes of rays o, ix (M, 1, 3) against boxes (M, K, 3), with
    near clamped to t_min and far to t_max (M, 1); NaNs as the port reads
    them. Also the clamped near t (for ordering)."""
    t0 = (lo - o) * ix
    t1 = (hi - o) * ix
    tn = torch.minimum(t0, t1)
    tf = torch.maximum(t0, t1)
    near = torch.maximum(torch.maximum(tn[..., 0], tn[..., 1]), tn[..., 2])
    far = torch.minimum(torch.minimum(tf[..., 0], tf[..., 1]), tf[..., 2])
    near = torch.where(torch.isnan(near), -torch.inf, near)
    far = torch.where(torch.isnan(far), torch.inf, far)
    near = torch.clamp(near, min=t_min)
    return near <= torch.minimum(far, t_max), near


def triangle_tuv(o, d, v0, e1, e2, t_min, t_max=T_MAX):
    """The port's Möller–Trumbore: (t, u, v), t = T_MAX on a miss."""
    pvec = cross(d, e2)
    det = vdot(e1, pvec)
    degenerate = det == 0.0
    inv_det = 1.0 / torch.where(degenerate, torch.ones_like(det), det)
    tvec = o - v0
    u = vdot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = vdot(d, qvec) * inv_det
    t = vdot(e2, qvec) * inv_det
    valid = (~degenerate & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= t_min)
             & (t <= t_max))
    return torch.where(valid, t, torch.full_like(t, T_MAX)), u, v


def _walk(o, d, bvh: BVH, bound, any_hit: bool):
    """One block of rays. Closest hit: (t, prim), prim -1 on a miss, t the
    smallest hit below `bound`. Any hit: blocked where a hit lies in
    [T_MIN, bound)."""
    B, dev, dt = o.shape[0], o.device, bvh.dtype
    o, d = o.to(dt), d.to(dt)
    ix = 1.0 / d
    best = bound.to(dt).clone()
    prim = torch.full((B,), -1, dtype=torch.int64, device=dev)
    blocked = torch.zeros(B, dtype=torch.bool, device=dev)
    if bvh.big.numel():
        tb = bvh.big
        t, _, _ = triangle_tuv(o[:, None], d[:, None], bvh.v0[tb][None], bvh.e1[tb][None],
                               bvh.e2[tb][None], T_MIN, best[:, None])
        if any_hit:
            blocked = (t < best[:, None]).any(1)
        else:
            tmin = t.amin(1)
            k = (t == tmin[:, None]).int().argmax(1)
            better = tmin < best
            best = torch.where(better, tmin, best)
            prim = torch.where(better, tb[k], prim)
    stack = torch.zeros((B, _STACK), dtype=torch.int64, device=dev)
    ok, _ = _slab(o[:, None], ix[:, None], T_MIN, best[:, None], bvh.lo[1][None, None],
                  bvh.hi[1][None, None])
    stack[:, 0] = 1
    sp = (ok[:, 0] & ~blocked).long()
    P = bvh.P
    while True:
        act = torch.nonzero(sp > 0).squeeze(1)
        if act.numel() == 0:
            break
        spa = sp[act] - 1
        node = stack[act, spa]
        oa, da, ia, ba = o[act], d[act], ix[act], best[act]
        kids = torch.stack([2 * node, 2 * node + 1], 1)  # (M, 2)
        hit, near = _slab(oa[:, None], ia[:, None], T_MIN, ba[:, None], bvh.lo[kids],
                          bvh.hi[kids])
        hit = hit & bvh.full[kids]
        leaf = kids[:, 0] >= P
        done = torch.zeros(act.numel(), dtype=torch.bool, device=dev)
        li = torch.nonzero(leaf & hit.any(1)).squeeze(1)
        if li.numel():
            tri = bvh.leaf_tri[(kids[li] - P).clamp(max=P - 1)]  # (L, 2, LEAF)
            tri = torch.where(hit[li][:, :, None], tri, -1).view(li.numel(), 2 * LEAF)
            tc = tri.clamp(min=0)
            t, _, _ = triangle_tuv(oa[li][:, None], da[li][:, None], bvh.v0[tc], bvh.e1[tc],
                                   bvh.e2[tc], T_MIN, ba[li][:, None])
            t = torch.where(tri >= 0, t, T_MAX)
            if any_hit:
                got = (t < ba[li][:, None]).any(1)
                blocked[act[li[got]]] = True
                done[li[got]] = True
            else:
                tmin = t.amin(1)
                k = (t == tmin[:, None]).int().argmax(1)
                better = tmin < ba[li]
                w = act[li[better]]
                best[w] = tmin[better]
                prim[w] = tri[better, k[better]]
        # Internal children that pass: the far one first, so the near pops next.
        inner = ~leaf & ~done
        far_first = near[:, 0] <= near[:, 1]
        c_far = torch.where(far_first, kids[:, 1], kids[:, 0])
        c_near = torch.where(far_first, kids[:, 0], kids[:, 1])
        h_far = torch.where(far_first, hit[:, 1], hit[:, 0]) & inner
        h_near = torch.where(far_first, hit[:, 0], hit[:, 1]) & inner
        pos = spa.clone()
        r = torch.nonzero(h_far).squeeze(1)
        stack[act[r], pos[r]] = c_far[r]
        pos = pos + h_far.long()
        r = torch.nonzero(h_near).squeeze(1)
        stack[act[r], pos[r]] = c_near[r]
        pos = pos + h_near.long()
        sp[act] = torch.where(done, 0, pos)
    return blocked if any_hit else (best, prim)


_BLOCK = 1 << 18


def intersect(o, d, bvh: BVH, alive=None):
    """Closest hit (t, prim) of every ray, prim -1 on a miss; dead lanes
    (alive False) miss."""
    n = o.shape[0]
    t = torch.full((n,), T_MAX, dtype=bvh.dtype, device=o.device)
    prim = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    rays = torch.arange(n, device=o.device) if alive is None else torch.nonzero(alive).squeeze(1)
    for s in range(0, rays.numel(), _BLOCK):
        r = rays[s:s + _BLOCK]
        bt, bp = _walk(o[r].detach(), d[r].detach(), bvh,
                       torch.full((r.numel(),), T_MAX, dtype=bvh.dtype, device=o.device), False)
        t[r], prim[r] = bt, bp
    return t, prim


def occluded(o, d, bvh: BVH, t_far):
    """True where a triangle is hit at T_MIN <= t < t_far."""
    n = o.shape[0]
    out = torch.zeros(n, dtype=torch.bool, device=o.device)
    rays = torch.nonzero(t_far > 0).squeeze(1)
    for s in range(0, rays.numel(), _BLOCK):
        r = rays[s:s + _BLOCK]
        out[r] = _walk(o[r].detach(), d[r].detach(), bvh, t_far[r].detach(), True)
    return out


# --------------------------------------------------------------------------
# Camera, textures, refinement, lights and the integrators.
# --------------------------------------------------------------------------


def camera_rays(scene: Scene, height: int, width: int, root, sample_idx, jitter: bool,
                pixel_id):
    """(o, d, keys) of the camera rays of `pixel_id` (N,), sample
    `sample_idx` (scalar or (N,))."""
    cam, dt = scene.cam, scene.dtype
    pixel_keys = fold(fold(root, pixel_id), sample_idx)
    nbx = -(-width // 32)
    block_id = (pixel_id // width) // 4 * nbx + (pixel_id % width) // 32
    block_keys = fold(fold(fold(root, _BLOCK_NS), block_id), sample_idx)
    keys = torch.cat([pixel_keys, block_keys], dim=-1)
    n = pixel_id.shape[0]
    if jitter:
        uv = uniform(pixel_keys, 2, 0, dt)
        jx, jy = uv[:, 0], uv[:, 1]
    else:
        jx = torch.full((n,), 0.5, dtype=dt, device=pixel_id.device)
        jy = jx
    i = (pixel_id // width).to(dt)
    j = (pixel_id % width).to(dt)
    half_h = torch.tan(cam["fov_deg"] * (math.pi / 180.0) * 0.5)
    aspect = width / height
    ndc_x = ((j + jx) / width * 2.0 - 1.0) * half_h * aspect
    ndc_y = (1.0 - (i + jy) / height * 2.0) * half_h
    fwd = normalize(cam["look_at"] - cam["origin"])
    right = normalize(cross(fwd, cam["up"]))
    up = cross(right, fwd)
    d = normalize(fwd[None, :] + ndc_x[:, None] * right[None, :] + ndc_y[:, None] * up[None, :])
    return cam["origin"].expand(d.shape), d, keys


def _wrap1(x):
    r = torch.fmod(x, 1.0)
    return torch.where(r < 0, r + 1.0, r)


def sample_texture(atlas, tex_id, uv):
    ones = torch.ones(uv.shape[:-1] + (3,), dtype=uv.dtype, device=uv.device)
    if atlas.shape[0] == 0:
        return ones
    res = atlas.shape[1]
    k = torch.clamp(tex_id, 0, atlas.shape[0] - 1).long()
    u = _wrap1(uv[..., 0]) * res - 0.5
    v = _wrap1(uv[..., 1]) * res - 0.5
    u0, v0 = torch.floor(u), torch.floor(v)
    fu, fv = (u - u0)[..., None], (v - v0)[..., None]
    u0i = torch.remainder(u0.to(torch.int32), res).long()
    v0i = torch.remainder(v0.to(torch.int32), res).long()
    u1i, v1i = torch.remainder(u0i + 1, res), torch.remainder(v0i + 1, res)
    out = (atlas[k, v0i, u0i] * ((1 - fu) * (1 - fv)) + atlas[k, v0i, u1i] * (fu * (1 - fv))
           + atlas[k, v1i, u0i] * ((1 - fu) * fv) + atlas[k, v1i, u1i] * (fu * fv))
    return torch.where((tex_id >= 0)[..., None], out, ones)


def _tri(scene: Scene, prim):
    """(v0, e1, e2, uv0, duv1, duv2, material) of triangles `prim`."""
    i = scene.idx[prim]
    v0 = scene.verts[i[:, 0]]
    e1, e2 = scene.verts[i[:, 1]] - v0, scene.verts[i[:, 2]] - v0
    uv0 = scene.uv[i[:, 0]]
    return v0, e1, e2, uv0, scene.uv[i[:, 1]] - uv0, scene.uv[i[:, 2]] - uv0, scene.tri_mat[prim]


def refine(o, d, prim, scene: Scene):
    """Shading geometry of the hits `prim` (-1: miss) as a dict."""
    dt = scene.dtype
    n = o.shape[0]
    is_t = prim >= 0
    tp = prim.clamp(min=0)
    v0, e1, e2, uv0, duv1, duv2, mat = _tri(scene, tp)
    tt, bu, bv = triangle_tuv(o, d, v0, e1, e2, T_MIN)
    ng = normalize(cross(e1, e2))
    uv = uv0 + bu[:, None] * duv1 + bv[:, None] * duv2
    t = torch.where(is_t, tt, torch.full((n,), T_MAX, dtype=dt, device=o.device))
    valid = is_t & (t < T_MAX)
    p = o + torch.where(valid, t, 0.0)[:, None] * d
    flip = torch.where(vdot(ng, d) > 0.0, -1.0, 1.0).to(dt)
    nrm = ng * flip[:, None]
    mat = torch.where(valid, mat, 0)
    tex = sample_texture(scene.textures, scene.tex_id[mat], uv)
    vm = valid[:, None]
    return {"valid": valid, "p": torch.where(vm, p, 0.0), "n": torch.where(vm, nrm, 0.0),
            "albedo": torch.where(vm, scene.albedo.index_select(0, mat) * tex, 0.0),
            "emission": torch.where(vm, scene.emission.index_select(0, mat), 0.0)}


def _light_rows(scene: Scene):
    """(a0, a1, a2, unit normal, pdf, material) of every light triangle."""
    i = scene.idx[scene.light_prim]
    v0, v1, v2 = scene.verts[i[:, 0]], scene.verts[i[:, 1]], scene.verts[i[:, 2]]
    c = cross(v1 - v0, v2 - v0)
    twice_area = length(c)
    return (v0, v1, v2, c / torch.clamp(twice_area, min=EPS)[..., None],
            2.0 / torch.clamp(twice_area, min=EPS), scene.tri_mat[scene.light_prim])


def _light_contrib(scene: Scene, geom, bvh: BVH, light, u1, u2, rows):
    a0, a1, a2, nl, pdf, lmat = (x.index_select(0, light) for x in rows)
    su = torch.sqrt(torch.clamp(u1, min=1e-12))
    b0 = 1.0 - su
    b1 = u2 * su
    p_l = b0[:, None] * a0 + b1[:, None] * a1 + (1.0 - b0 - b1)[:, None] * a2
    to_l = p_l - geom["p"]
    dist2 = vdot(to_l, to_l)
    dist = torch.sqrt(torch.clamp(dist2, min=1e-12))
    wi = to_l / dist[:, None]
    cos_s = torch.clamp(vdot(geom["n"], wi), min=0.0)
    cos_l = torch.abs(vdot(nl, wi))
    emit = scene.emission.index_select(0, lmat)
    shadow_o = geom["p"] + geom["n"] * RAY_EPS
    t_far = torch.where(geom["valid"], dist.detach() * (1.0 - 1e-3), 0.0)
    blocked = occluded(shadow_o, wi, bvh, t_far)
    weight = cos_s * cos_l / torch.clamp(dist2, min=1e-8) / torch.clamp(pdf, min=EPS)
    contrib = geom["albedo"] * INV_PI * emit * weight[:, None]
    return torch.where((geom["valid"] & ~blocked)[:, None], contrib, 0.0)


def nee(scene: Scene, geom, keys, bvh: BVH, bounce: int, deterministic: bool):
    n = keys.shape[0]
    dt, dev = scene.dtype, keys.device
    rows = _light_rows(scene)
    n_lights = scene.light_prim.numel()
    if deterministic:
        total = torch.zeros((n, 3), dtype=dt, device=dev)
        u1 = torch.full((n,), DET_U1, dtype=dt, device=dev)
        u2 = torch.full((n,), DET_U2, dtype=dt, device=dev)
        for lt in range(n_lights):
            light = torch.full((n,), lt, dtype=torch.int64, device=dev)
            total = total + _light_contrib(scene, geom, bvh, light, u1, u2, rows)
        return total
    u = uniform(fold(keys[:, 2:4], bounce), 3, 0, torch.float32)
    light = torch.clamp((u[:, 0] * n_lights).to(torch.int32), max=n_lights - 1).long()
    return _light_contrib(scene, geom, bvh, light, u[:, 1].to(dt), u[:, 2].to(dt),
                          rows) * n_lights


def li_direct(o, d, keys, scene: Scene, bvh: BVH, deterministic: bool, prim=None):
    if prim is None:
        _, prim = intersect(o, d, bvh)
    geom = refine(o, d, prim, scene)
    return geom["emission"] + nee(scene, geom, keys, bvh, 0, deterministic)


def sample_cosine(n, u1, u2):
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    x, y = r * torch.cos(phi), r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    t, b, nn = make_onb(n)
    return x[..., None] * t + y[..., None] * b + z[..., None] * nn


def li_path(o, d, keys, scene: Scene, bvh: BVH, max_depth: int, deterministic: bool,
            rr_start: int):
    """Path tracing with NEE at each vertex and Russian roulette (no
    compaction: the port's compaction is a permutation)."""
    dt, dev = scene.dtype, o.device
    n = o.shape[0]
    use_rr = rr_start > 0 and not deterministic
    beta = torch.ones((n, 3), dtype=dt, device=dev)
    radiance = torch.zeros((n, 3), dtype=dt, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    for b in range(max_depth):
        _, prim = intersect(o, d, bvh, alive=alive)
        geom = refine(o, d, prim, scene)
        alive = alive & geom["valid"]
        if b == 0:
            radiance = radiance + torch.where(alive[:, None], geom["emission"], 0.0)
        radiance = radiance + torch.where(
            alive[:, None], beta * nee(scene, geom, keys, bvh, b, deterministic), 0.0)
        bk = fold(keys[:, :2], b)
        u = uniform(bk, 2, 1, dt)
        new_d = sample_cosine(geom["n"], u[:, 0], u[:, 1])
        new_o = geom["p"] + geom["n"] * RAY_EPS
        beta = beta * geom["albedo"]
        alive = alive & (torch.amax(beta, dim=1) > 1e-5)
        if use_rr and b >= rr_start:
            u_rr = uniform(bk, 1, 2, dt)[:, 0]
            p = torch.clamp(torch.amax(beta, dim=1), 0.05, 1.0)
            beta = beta * (1.0 / p)[:, None]
            alive = alive & (u_rr < p)
        o = torch.where(alive[:, None], new_o, o)
        d = torch.where(alive[:, None], new_d, d)
    return radiance


def _tri_geom(o, d, scene: Scene, prim, t_plane, valid):
    """Shading geometry on triangle `prim` at its plane hit."""
    tp = prim.clamp(min=0)
    i = scene.idx[tp]
    i0, i1, i2 = i[:, 0], i[:, 1], i[:, 2]
    v0 = scene.verts.index_select(0, i0)
    e1 = scene.verts.index_select(0, i1) - v0
    e2 = scene.verts.index_select(0, i2) - v0
    nrm = normalize(cross(e1, e2))
    p = o + t_plane[:, None] * d
    pvec = cross(d, e2)
    det = vdot(e1, pvec)
    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
    tvec = o - v0
    u = vdot(tvec, pvec) * inv_det
    v = vdot(d, cross(tvec, e1)) * inv_det
    uv = ((1.0 - u - v)[:, None] * scene.uv.index_select(0, i0)
          + u[:, None] * scene.uv.index_select(0, i1) + v[:, None] * scene.uv.index_select(0, i2))
    nrm = nrm * torch.where(vdot(nrm, d) > 0.0, -1.0, 1.0).to(nrm.dtype)[:, None]
    mat = scene.tri_mat[tp]
    tex = sample_texture(scene.textures, scene.tex_id[mat], uv)
    vm = valid[:, None]
    return {"valid": valid, "p": torch.where(vm, p, 0.0), "n": torch.where(vm, nrm, 0.0),
            "albedo": torch.where(vm, scene.albedo.index_select(0, mat) * tex, 0.0),
            "emission": torch.where(vm, scene.emission.index_select(0, mat), 0.0)}


def mesh_soft(o, d, keys, scene: Scene, bvh: BVH, deterministic: bool, sigma: float, hw,
              prim):
    """Soft mesh-silhouette radiance over each pixel's own and its four
    image neighbours' hit triangles (rays in row-major order), composited
    front to back; no opaque last layer, a black environment."""
    h, w = hw
    n, dev, dt = o.shape[0], o.device, scene.dtype
    pix_ang = (2.0 * torch.tan(scene.cam["fov_deg"] * (math.pi / 180.0) * 0.5) / h).detach()
    pimg = prim.reshape(h, w)
    cands = [pimg, torch.roll(pimg, 1, 0), torch.roll(pimg, -1, 0), torch.roll(pimg, 1, 1),
             torch.roll(pimg, -1, 1)]
    cands = [c.reshape(n) for c in cands]
    dedup = [cands[0]]
    for c in cands[1:]:
        dup = torch.zeros((n,), dtype=torch.bool, device=dev)
        for seen in dedup:
            dup = dup | (c == seen)
        dedup.append(torch.where(dup, -1, c))
    alphas, ts = [], []
    for c in dedup:
        tp = c.clamp(min=0)
        i = scene.idx[tp]
        v0 = scene.verts.index_select(0, i[:, 0])
        e1 = scene.verts.index_select(0, i[:, 1]) - v0
        e2 = scene.verts.index_select(0, i[:, 2]) - v0
        pvec = cross(d, e2)
        det = vdot(e1, pvec)
        degenerate = det == 0.0
        inv_det = 1.0 / torch.where(degenerate, 1.0, det)
        tvec = o - v0
        u = vdot(tvec, pvec) * inv_det
        qvec = cross(tvec, e1)
        v = vdot(d, qvec) * inv_det
        t_pl = vdot(e2, qvec) * inv_det
        n2 = cross(e1, e2)
        area2 = torch.sqrt(torch.clamp(vdot(n2, n2), min=1e-20))
        h_u = area2 / torch.clamp(torch.linalg.vector_norm(e2, dim=-1), min=1e-10)
        h_v = area2 / torch.clamp(torch.linalg.vector_norm(e1, dim=-1), min=1e-10)
        h_w = area2 / torch.clamp(torch.linalg.vector_norm(e2 - e1, dim=-1), min=1e-10)
        d_world = torch.minimum(torch.minimum(u * h_u, v * h_v), (1.0 - u - v) * h_w)
        footprint = torch.clamp(t_pl, min=RAY_EPS) * pix_ang
        alpha = torch.sigmoid(d_world / (sigma * footprint))
        ok = (c >= 0) & ~degenerate & (t_pl > RAY_EPS)
        alphas.append(torch.where(ok, alpha, 0.0))
        ts.append(torch.where(ok, t_pl, _NO_T))
    A, T, Pr = torch.stack(alphas, 1), torch.stack(ts, 1), torch.stack(dedup, 1)
    order = torch.argsort(T.float(), dim=1, stable=True)
    A, T, Pr = torch.gather(A, 1, order), torch.gather(T, 1, order), torch.gather(Pr, 1, order)
    soft = torch.zeros((n, 3), dtype=dt, device=dev)
    trans = torch.ones((n,), dtype=dt, device=dev)
    for k in range(len(dedup)):
        geom = _tri_geom(o, d, scene, Pr[:, k], T[:, k], (A[:, k] > 0.0) & (T[:, k] < 1e29))
        l_k = geom["emission"] + nee(scene, geom, keys, bvh, 0, deterministic)
        soft = soft + (trans * A[:, k])[:, None] * l_k
        trans = trans * (1.0 - A[:, k])
    return soft


# --------------------------------------------------------------------------
# What the benchmark compares.
# --------------------------------------------------------------------------


#: RenderConfig's defaults of the keys the reference reads.
DEFAULTS = {"integrator": "direct", "max_depth": 4, "rr_start": 0, "deterministic": False,
            "jitter": True, "soft_sigma": 0.0, "soft_mesh": False}
#: The integrators the reference renders; the port runs "primary" and
#: "direct" both as li_direct.
INTEGRATORS = ("primary", "direct", "path")


def settings(cfg: dict) -> dict:
    """cfg over DEFAULTS; an integrator the reference does not render
    raises."""
    out = {**DEFAULTS, **cfg}
    if out["integrator"] not in INTEGRATORS:
        raise KeyError(f"the reference has no integrator {out['integrator']!r}; "
                       f"it renders {INTEGRATORS}")
    return out


def _soft_mesh(cfg: dict) -> bool:
    """Soft mesh-silhouette gradients: one-bounce integrators only (the
    port's path integrator takes no soft terms)."""
    return cfg["soft_sigma"] > 0.0 and cfg["soft_mesh"] and cfg["integrator"] != "path"


def radiance(cfg: dict, scene: Scene, bvh: BVH, pid, sample, sampler_seed: int):
    """Radiance (N, 3) of pixels `pid`, sample `sample` (scalar or (N,)),
    under cfg's integrator. Under autograd and soft mesh silhouettes, the
    soft terms' gradient is added (their value is nought); they read each
    pixel's image neighbours, so `pid` is then the whole image."""
    cfg = settings(cfg)
    h, w = cfg["height"], cfg["width"]
    det = cfg["deterministic"]
    root = seed_key(sampler_seed, scene.device)
    o, d, keys = camera_rays(scene, h, w, root, sample, cfg["jitter"] and not det, pid)
    if cfg["integrator"] == "path":
        return li_path(o, d, keys, scene, bvh, cfg["max_depth"], det, cfg["rr_start"])
    _, prim = intersect(o, d, bvh)
    out = li_direct(o, d, keys, scene, bvh, det, prim)
    if _soft_mesh(cfg) and torch.is_grad_enabled():
        soft = mesh_soft(o.detach(), d.detach(), keys, scene, bvh, det, cfg["soft_sigma"],
                         (h, w), prim)
        out = out + (soft - soft.detach())
    return out


def loss_and_grads(arrays: dict, cfg: dict, params, target, sampler_seed: int, device,
                   dtype=torch.float32, block_rows: int = 256):
    """(loss, grads by name) of the pixel MSE of cfg's image against
    `target` (H, W, 3), for the named parameters, in row blocks (the whole
    image at once under soft mesh silhouettes, which read neighbours).
    The loss and gradients come back in float32."""
    scene = Scene(arrays, device, dtype)
    bvh = BVH(scene)
    leaves = scene.params(params)
    h, w, spp = cfg["height"], cfg["width"], cfg["spp"]
    if _soft_mesh(settings(cfg)):
        block_rows = h
    target = target.to(device=device, dtype=dtype).reshape(h * w, 3)
    loss = 0.0
    for r0 in range(0, h, block_rows):
        pid = torch.arange(r0 * w, min(h, r0 + block_rows) * w, device=device)
        acc = 0.0
        for s in range(spp):
            acc = acc + radiance(cfg, scene, bvh, pid, s, sampler_seed)
        part = torch.sum((acc / spp - target[pid]) ** 2) / (h * w * 3)
        part.backward()
        loss += float(part.detach().float())
    return loss, {n: p.grad.detach().float() for n, p in leaves.items()}


def frame_pixels(arrays: dict, cfg: dict, pid, sampler_seed: int, device,
                 dtype=torch.float32, block_pixels: int = 16384):
    """(N, 3) float32 radiance of pixels `pid` of a frame under cfg's
    integrator (all spp samples, averaged)."""
    scene = Scene(arrays, device, dtype)
    bvh = BVH(scene)
    spp = cfg["spp"]
    out = []
    with torch.no_grad():
        for s0 in range(0, pid.numel(), block_pixels):
            p = pid[s0:s0 + block_pixels].to(device)
            sidx = torch.arange(spp, device=device).repeat(p.numel())
            li = radiance(cfg, scene, bvh, p.repeat_interleave(spp), sidx, sampler_seed)
            out.append((li.reshape(-1, spp, 3).sum(1) / spp).float())
    return torch.cat(out)
