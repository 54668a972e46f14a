"""Backend: the traversal implementation and its acceleration data
(counterpart of `blink.kernels.api`).

  brute — every ray against every primitive, plain torch (the oracle; any
          scene, O(rays x primitives));
  wide  — the chunked, quantized 8-wide BVH (`pallas` in `blink`, accepted
          as an alias): the CUDA walks and sphere kernel on a CUDA device,
          their plain torch versions on the CPU;
  auto  — brute at 64 triangles or fewer, else wide (`blink`'s rule).

`bvh` (the flat skip-link walk) comes with a later slice (ROADMAP.md
queue 1). Traversal is a topology oracle: every input is detached and no
output carries a gradient; gradients come from diff.hitrefine.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from blink_torch.kernels.bruteforce import intersect_brute, occluded_brute
from blink_torch.kernels.sphere import sphere_pass
from blink_torch.kernels.traverse_wide import (
    WideChunk,
    build_chunked_wide,
    traverse_anyhit_wide,
    traverse_closest_wide,
)
from blink_torch.kernels.types import KIND_NONE, KIND_SPHERE, KIND_TRI, T_MAX, T_MIN, Hit
from blink_torch.scene.scene import Scene
from blink_torch.scene.shade import pack_tri_shade_np

BACKENDS = ("auto", "brute", "wide", "pallas")

#: `auto` picks brute up to this many triangles.
BRUTE_MAX_TRIS = 64


@dataclasses.dataclass(frozen=True)
class Backend:
    name: str  # "brute" | "wide"
    chunks: list[WideChunk] | None = None
    #: (T, 16) packed per-triangle shading table (scene.shade). None:
    #: render_image packs it in the graph from the live scene.
    shade: torch.Tensor | None = None

    def intersect(self, o, d, scene: Scene, alive=None) -> Hit:
        """Closest hit. `alive`: optional lane mask — dead lanes report the
        canonical miss, and on wide skip the walk (t_far = 0)."""
        o, d = o.detach().contiguous(), d.detach().contiguous()
        if self.name == "brute":
            return intersect_brute(o, d, scene, alive=alive)
        tf = None
        if alive is not None:
            tf = torch.where(alive, T_MAX, 0.0).to(torch.float32)
        best_t, tri_prim = traverse_closest_wide(o, d, self.chunks, t_far=tf)
        kind = torch.where(tri_prim >= 0, KIND_TRI, KIND_NONE).to(torch.int32)
        prim = torch.clamp(tri_prim, min=0)
        if scene.n_spheres > 0:
            if alive is not None:
                # Dead lanes must not pick up sphere hits.
                best_t = torch.where(alive, best_t, 0.0)
            sph = scene.spheres
            s_t, s_prim = sphere_pass(
                o, d, sph.center.detach(), sph.radius.detach(), T_MIN, best_t
            )
            s_better = s_t < best_t
            best_t = torch.where(s_better, s_t, best_t)
            kind = torch.where(s_better, KIND_SPHERE, kind).to(torch.int32)
            prim = torch.where(s_better, s_prim, prim)
        if alive is not None:
            # Canonical dead-lane Hit, identical across backends.
            best_t = torch.where(alive, best_t, T_MAX)
            kind = torch.where(alive, kind, KIND_NONE).to(torch.int32)
            prim = torch.where(alive, prim, 0)
        return Hit(t=best_t, kind=kind, prim=prim)

    def occluded(self, o, d, scene: Scene, t_far) -> torch.Tensor:
        """True where a primitive is hit at T_MIN <= t < t_far (brute: up to
        and including t_far, as `blink`'s brute backend)."""
        o, d = o.detach().contiguous(), d.detach().contiguous()
        t_far = t_far.detach().to(torch.float32).contiguous()
        if self.name == "brute":
            return occluded_brute(o, d, scene, t_far)
        blocked = traverse_anyhit_wide(o, d, self.chunks, t_far)
        if scene.n_spheres > 0:
            sph = scene.spheres
            s_t, _ = sphere_pass(
                o, d, sph.center.detach(), sph.radius.detach(), T_MIN, t_far
            )
            blocked = blocked | (s_t < t_far)
        return blocked


def make_backend(name: str, scene: Scene) -> Backend:
    """Build the backend's acceleration data on the host and place it on
    the scene's device. Production constants of `blink`'s pallas backend:
    340k-triangle Morton chunks, wide leaves of 44, quantized child boxes,
    chunks near to far from the build-time camera origin."""
    if name == "bvh":
        raise NotImplementedError(
            "backend 'bvh' (the flat skip-link walk) is not ported yet "
            "(ROADMAP.md queue 1)"
        )
    if name not in BACKENDS:
        raise KeyError(f"unknown backend '{name}'; choices: {BACKENDS}")
    if name == "auto":
        name = "brute" if scene.n_triangles <= BRUTE_MAX_TRIS else "wide"
    if name == "brute":
        return Backend(name="brute")
    if scene.n_triangles == 0:
        raise ValueError("the wide backend needs triangles; use 'brute'")
    device = scene.device
    cam_o = scene.camera.origin.detach().cpu().numpy().astype(np.float32)
    chunks = build_chunked_wide(
        scene.triangles, chunk_tris=340_000, wide_leaf=44, order_from=cam_o
    )
    return Backend(
        name="wide",
        chunks=[WideChunk.from_host(c, device) for c in chunks],
        shade=torch.as_tensor(pack_tri_shade_np(scene.triangles)).to(device),
    )
