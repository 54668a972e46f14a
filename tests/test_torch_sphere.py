"""blink_torch's sphere pass and backends against blink.

- The plain `sphere_pass` (the CPU path, and what the CUDA kernel is held
  against on the card) against blink's Pallas sphere kernel in interpret
  mode and against that kernel's body in numpy: prim exactly, t within
  rtol/atol 1e-6 of the numpy body, with 8 and 64 spheres, duplicated
  spheres (first-minimum ties) and caps of T_MAX, finite values and 0.
- The port's `brute` and `wide` backends against blink's `brute` on the
  Cornell scene: Hit kind and prim exactly, t within 1e-6, occlusion flags
  exactly.
- Traversal severs autograd, as blink's stop_gradient does.
"""
import numpy as np
import pytest
import torch

from blink.kernels.bruteforce import intersect_brute as jax_intersect_brute
from blink.kernels.bruteforce import occluded_brute as jax_occluded_brute
from blink.kernels.sphere import sphere_pass_pallas
from blink.scene import builders as jax_builders
from blink_torch.api import render_grad
from blink_torch.config import get_config
from blink_torch.kernels import api as kapi
from blink_torch.kernels import sphere as ks
from blink_torch.kernels.api import make_backend
from blink_torch.kernels.types import KIND_SPHERE, T_MAX, T_MIN
from blink_torch.scene import builders

N_RAYS = 1024
TOL = dict(rtol=1e-6, atol=1e-6)


def _sphere_case(n_spheres: int, dup: bool, seed: int = 11):
    """Rays and spheres from a numpy seed; a third of the caps T_MAX, a
    third finite, a third 0. With `dup` the second half of the spheres
    repeats the first, so tied minima occur."""
    rng = np.random.default_rng(seed)
    s = n_spheres // 2 if dup else n_spheres
    center = rng.uniform(-3, 3, (s, 3)).astype(np.float32)
    radius = rng.uniform(0.2, 1.2, (s,)).astype(np.float32)
    if dup:
        center, radius = np.concatenate([center, center]), np.concatenate([radius, radius])
    o = rng.uniform(-6, 6, (N_RAYS, 3)).astype(np.float32)
    aim = center[rng.integers(0, n_spheres, N_RAYS)] + rng.normal(0, 0.8, (N_RAYS, 3))
    d = (aim - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    kind = np.arange(N_RAYS) % 3
    caps = np.where(kind == 0, T_MAX, np.where(kind == 1, rng.uniform(0.5, 12.0, N_RAYS), 0.0))
    return o, d, center, radius, caps.astype(np.float32)


def _kernel_numpy(o, d, center, radius, t_min, caps):
    """blink's `_make_sphere_kernel` body evaluated in numpy float32, one
    rounding per operation (no contracted multiply-add)."""
    f32 = np.float32
    dx, dy, dz = d.T
    a = dx * dx + dy * dy + dz * dz
    inv_a = f32(1.0) / a
    best = np.minimum(caps, f32(T_MAX))
    cap = best.copy()
    prim = np.full(caps.shape, -1, np.int32)
    for s in range(center.shape[0]):
        ocx, ocy, ocz = (o - center[s]).T
        half_b = ocx * dx + ocy * dy + ocz * dz
        c = ocx * ocx + ocy * ocy + ocz * ocz - radius[s] * radius[s]
        disc = half_b * half_b - a * c
        hit_disc = disc > 0.0
        sq = np.sqrt(np.where(hit_disc, disc, f32(1.0)))
        t0 = (-half_b - sq) * inv_a
        t1 = (-half_b + sq) * inv_a
        t = np.where(t0 >= f32(t_min), t0, t1)
        better = hit_disc & (t >= f32(t_min)) & (t <= cap) & (t < best)
        best = np.where(better, t, best)
        prim = np.where(better, s, prim)
    return np.where(prim >= 0, best, f32(T_MAX)), np.maximum(prim, 0)


@pytest.mark.parametrize("n_spheres, dup", [(8, False), (64, False), (8, True)])
def test_sphere_pass_plain_matches_pallas_interpret(n_spheres, dup):
    """prim exactly against the Pallas kernel in interpret mode. t within
    rtol/atol 1e-6 against the kernel's body in numpy; against interpret
    mode within blink's own rtol 1e-5 (tests/test_intersect.py), since
    XLA's CPU compiler contracts `half_b*half_b - a*c` into a fused
    multiply-add, which moves t by up to ~6e-6 relative where that
    difference cancels."""
    o, d, center, radius, caps = _sphere_case(n_spheres, dup)
    t_ref, p_ref = sphere_pass_pallas(o, d, center, radius, caps, t_min=T_MIN,
                                      interpret=True)
    t, prim = ks.sphere_pass(*(torch.from_numpy(x) for x in (o, d, center, radius)),
                             T_MIN, torch.from_numpy(caps))
    won = np.asarray(t_ref) < T_MAX
    assert won.sum() > N_RAYS // 5  # the case has hits
    np.testing.assert_array_equal(prim.numpy(), np.asarray(p_ref))
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), rtol=1e-5, atol=1e-6)
    t_np, p_np = _kernel_numpy(o, d, center, radius, T_MIN, caps)
    np.testing.assert_array_equal(prim.numpy(), p_np)
    np.testing.assert_allclose(t.numpy(), t_np, **TOL)
    assert not won[caps == 0].any()
    if dup:
        assert (prim.numpy() < n_spheres // 2).all()  # the first of tied minima


def _cornell_rays():
    """The Cornell camera's 32x32 primary rays plus 1024 random rays inside
    the box, from a numpy seed."""
    from blink_torch.render.camera import generate_rays
    from blink_torch.core import sampler

    scene = builders.cornell_box()
    o_cam, d_cam, _ = generate_rays(scene.camera, 32, 32, sampler.seed_key(0), 0, False)
    rng = np.random.default_rng(5)
    o_rnd = rng.uniform(-0.9, 0.9, (1024, 3)).astype(np.float32) + np.float32([0, 1, 0])
    d_rnd = rng.standard_normal((1024, 3)).astype(np.float32)
    d_rnd /= np.linalg.norm(d_rnd, axis=1, keepdims=True)
    o = np.concatenate([o_cam.numpy(), o_rnd]).astype(np.float32)
    d = np.concatenate([d_cam.numpy(), d_rnd]).astype(np.float32)
    return scene, o, d


@pytest.mark.parametrize("backend", ["brute", "wide"])
def test_backend_hits_match_reference_brute_on_cornell(backend):
    scene, o, d = _cornell_rays()
    ref_scene = jax_builders.cornell_box()
    ref = jax_intersect_brute(o, d, ref_scene)
    b = make_backend(backend, scene)
    assert b.name == backend
    hit = b.intersect(torch.from_numpy(o), torch.from_numpy(d), scene)
    np.testing.assert_array_equal(hit.kind.numpy(), np.asarray(ref.kind))
    np.testing.assert_array_equal(hit.prim.numpy(), np.asarray(ref.prim))
    np.testing.assert_allclose(hit.t.numpy(), np.asarray(ref.t), **TOL)
    assert (hit.kind.numpy() == KIND_SPHERE).mean() > 0.1

    # Shadow rays from each hit towards the light panel's centre.
    t = np.asarray(ref.t)
    hit_any = t < T_MAX
    p = o + np.where(hit_any, t, 0.0)[:, None] * d - 1e-3 * d
    to = np.float32([0.0, 1.98, 0.0]) - p
    dist = np.linalg.norm(to, axis=1)
    sd = (to / dist[:, None]).astype(np.float32)
    tf = np.where(hit_any, dist * 0.999, 0.0).astype(np.float32)
    b_ref = np.asarray(jax_occluded_brute(p.astype(np.float32), sd, ref_scene, tf))
    blocked = b.occluded(torch.from_numpy(p.astype(np.float32)), torch.from_numpy(sd),
                         scene, torch.from_numpy(tf))
    assert 0 < b_ref.sum() < len(b_ref)
    np.testing.assert_array_equal(blocked.numpy(), b_ref)


def test_auto_backend_rule_and_bvh_raises():
    """auto: brute at 64 triangles or fewer, else wide (never bvh). bvh is
    ported now: on Cornell it returns blink's brute Hits, spheres included
    (the plain sphere pass under the strict < combine)."""
    assert make_backend("auto", builders.cornell_box()).name == "brute"
    assert make_backend("auto", builders.bunny_scene(1)).name == "wide"
    scene, o, d = _cornell_rays()
    b = make_backend("bvh", scene)
    assert b.name == "bvh"
    ref = jax_intersect_brute(o, d, jax_builders.cornell_box())
    hit = b.intersect(torch.from_numpy(o), torch.from_numpy(d), scene)
    np.testing.assert_array_equal(hit.kind.numpy(), np.asarray(ref.kind))
    np.testing.assert_array_equal(hit.prim.numpy(), np.asarray(ref.prim))
    np.testing.assert_allclose(hit.t.numpy(), np.asarray(ref.t), **TOL)


def test_traversal_severs_autograd(monkeypatch):
    """A cam_origin gradient through the wide backend on the CPU: the rays
    require grad, but every walk and sphere pass sees detached inputs and
    returns outputs that require none; the gradient still flows through
    refine and shading."""
    seen = []

    def spy(fn, name):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            outs = out if isinstance(out, tuple) else (out,)
            flat = [x for x in (*args, *kwargs.values(), *outs) if torch.is_tensor(x)]
            seen.append((name, [x.requires_grad for x in flat]))
            return out
        return wrapped

    passes = ("traverse_closest_wide", "traverse_anyhit_wide", "sphere_merge", "sphere_pass")
    for name in passes:
        monkeypatch.setattr(kapi, name, spy(getattr(kapi, name), name))
    cfg = get_config("cornell").override(width=16, height=16, deterministic=True,
                                         backend="wide")
    loss, g = render_grad(builders.cornell_box(), cfg, torch.zeros(16, 16, 3),
                          ("cam_origin",), device="cpu")
    names = {n for n, _ in seen}
    assert names == set(passes)
    assert not any(any(flags) for _, flags in seen)
    assert torch.isfinite(g["cam_origin"]).all() and g["cam_origin"].abs().max() > 0

    hit = make_backend("wide", builders.cornell_box()).intersect(
        torch.zeros(4, 3, requires_grad=True) + torch.tensor([0.0, 1.0, 3.0]),
        torch.tensor([[0.0, 0.0, -1.0]]).expand(4, 3), builders.cornell_box())
    assert not hit.t.requires_grad


@pytest.mark.gpu
def test_sphere_kernel_matches_plain_on_gpu():
    """The CUDA kernel against its plain version on the card: prim
    identical, t within 1e-6, one launch per call; the merged entry
    (sphere_merge) against sphere_merge_plain bit for bit, on hits of
    every kind. center and radius are read in place: views that are not
    contiguous raise, and their contiguous copies give the same result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for n_spheres, dup in ((8, False), (64, False), (8, True)):
        args = [torch.from_numpy(x).cuda() for x in _sphere_case(n_spheres, dup)]
        o, d, center, radius, caps = args
        before = ks.LAUNCHES["sphere_pass"]
        t, prim = ks.sphere_pass(o, d, center, radius, T_MIN, caps)
        assert ks.LAUNCHES["sphere_pass"] == before + 1
        t_p, prim_p = ks.sphere_pass_plain(o, d, center, radius, T_MIN, caps)
        assert torch.equal(prim, prim_p)
        torch.testing.assert_close(t, t_p, **TOL)
        kind = torch.arange(N_RAYS, device="cuda", dtype=torch.int32) % 3
        tri = torch.arange(N_RAYS, device="cuda", dtype=torch.int32) * 7
        before = ks.LAUNCHES["sphere_merge"]
        got = ks.sphere_merge(o, d, center, radius, T_MIN, caps, kind, tri)
        assert ks.LAUNCHES["sphere_merge"] == before + 1
        want = ks.sphere_merge_plain(o, d, center, radius, T_MIN, caps, kind, tri)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert (got[1] == KIND_SPHERE).any() and (got[1] != KIND_SPHERE).any()
    wide_c = torch.stack([center, center], 2)[:, :, 0]  # strided views
    wide_r = torch.stack([radius, radius], 1)[:, 0]
    assert not wide_c.is_contiguous() and not wide_r.is_contiguous()
    for c, r in ((wide_c, radius), (center, wide_r)):
        with pytest.raises(ValueError, match="must be contiguous"):
            ks.sphere_pass(o, d, c, r, T_MIN, caps)
        t_c, prim_c = ks.sphere_pass(o, d, c.contiguous(), r.contiguous(), T_MIN, caps)
        assert torch.equal(t_c, t) and torch.equal(prim_c, prim)
    with pytest.raises(ValueError, match="unrolls over spheres"):
        o, d, _, _, caps = args
        ks.sphere_pass(o, d, torch.zeros(65, 3, device="cuda"),
                       torch.ones(65, device="cuda"), T_MIN, caps)
