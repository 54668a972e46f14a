"""Direct-lighting integrator with next-event estimation (counterpart of
the direct half of `blink.render.integrators`; path tracing comes with a
later slice, ROADMAP.md queue 1).

Emission counts on camera-visible emitters; each hit adds one NEE sample
(uniform light choice, area sampling) tested by one shadow ray.
"""
from __future__ import annotations

import torch

from blink_torch.core import sampler, vec
from blink_torch.diff.brdf import INV_PI
from blink_torch.diff.hitrefine import HitGeom, refine
from blink_torch.sampling.lights import pack_light_rows, sample_light_point
from blink_torch.scene.scene import Scene

#: normal offset applied to shadow ray origins.
RAY_EPS = 1e-3

#: Stochastic NEE light samples are drawn per 4x32-pixel image block (the
#: block stream of the ray keys), so neighbouring shadow rays aim at one
#: light point. Unbiased; it changes only how the noise correlates.
NEE_SHARE_ROW = True

#: Fixed barycentrics placing a deterministic triangle-light sample at its
#: centroid (u1 = 4/9, u2 = 1/2 under the sqrt warp).
DET_U1 = 4.0 / 9.0
DET_U2 = 0.5


def _light_contrib(scene: Scene, geom: HitGeom, backend, light, u1, u2, light_rows):
    """Shadow-ray-tested contribution of one sampled light point (pdf-area
    weighted, without the light-choice factor)."""
    p_l, n_l, pdf_area, mat_l = sample_light_point(scene, light, u1, u2, rows=light_rows)
    to_l = p_l - geom.p
    dist2 = vec.vdot(to_l, to_l)
    dist = torch.sqrt(torch.clamp(dist2, min=1e-12))
    wi = to_l / dist[:, None]
    cos_s = torch.clamp(vec.vdot(geom.n, wi), min=0.0)
    cos_l = torch.abs(vec.vdot(n_l, wi))  # two-sided emitters
    emit = scene.materials.emission.index_select(0, mat_l.long())

    shadow_o = geom.p + geom.n * RAY_EPS
    # t_far = 0 for rays whose primary missed: they fail every slab test
    # and cost one root visit instead of a walk from a meaningless origin.
    # Visibility carries no gradient.
    t_far = torch.where(geom.valid, dist.detach() * (1.0 - 1e-3), 0.0)
    blocked = backend.occluded(shadow_o, wi, scene, t_far)

    geom_term = cos_s * cos_l / torch.clamp(dist2, min=1e-8)
    weight = geom_term / torch.clamp(pdf_area, min=vec.EPS)
    contrib = geom.albedo * INV_PI * emit * weight[:, None]
    active = geom.valid & ~blocked
    return torch.where(active[:, None], contrib, 0.0)


def nee_direct(scene: Scene, geom: HitGeom, keys, backend, bounce: int,
               deterministic: bool = False) -> torch.Tensor:
    """Next-event estimate of direct lighting at each hit.

    Stochastic: one sample, uniform light choice. Deterministic (goldens):
    the sum over every light sampled at a fixed interior point.
    """
    n = geom.t.shape[0]
    if scene.n_lights == 0:
        return torch.zeros((n, 3), dtype=torch.float32, device=geom.t.device)
    n_lights = scene.n_lights
    light_rows = pack_light_rows(scene)
    if deterministic:
        if n_lights > 16:
            raise ValueError(
                f"deterministic light sampling traces one shadow pass per "
                f"light; {n_lights} lights is too many. Use stochastic NEE."
            )
        total = torch.zeros((n, 3), dtype=torch.float32, device=geom.t.device)
        u1 = torch.full((n,), DET_U1, dtype=torch.float32, device=geom.t.device)
        u2 = torch.full((n,), DET_U2, dtype=torch.float32, device=geom.t.device)
        for l in range(n_lights):
            light = torch.full((n,), l, dtype=torch.int32, device=geom.t.device)
            total = total + _light_contrib(scene, geom, backend, light, u1, u2, light_rows)
        return total
    stream = keys[:, 2:4] if NEE_SHARE_ROW and keys.shape[-1] >= 4 else keys[:, :2]
    u = sampler.uniform(sampler.bounce_key(stream, bounce), 3, dim=0)
    light = torch.clamp((u[:, 0] * n_lights).to(torch.int32), max=n_lights - 1)
    contrib = _light_contrib(scene, geom, backend, light, u[:, 1], u[:, 2], light_rows)
    return contrib * n_lights  # 1 / P(choose light)


def li_direct(o, d, keys, scene: Scene, backend, deterministic: bool = False):
    """Emission + direct lighting."""
    hit = backend.intersect(o, d, scene)
    geom = refine(o, d, hit, scene, shade=backend.shade)
    return geom.emission + nee_direct(
        scene, geom, keys, backend, bounce=0, deterministic=deterministic
    )


INTEGRATORS = {"primary": li_direct, "direct": li_direct}
