"""Backend: the traversal implementation and its acceleration data
(counterpart of `blink.kernels.api`).

  wide — the chunked, quantized 8-wide BVH (`pallas` in `blink`): CUDA
         kernels on a CUDA device, their plain torch versions on the CPU.

`brute` and `bvh` (the flat skip-link walk) come with a later slice
(ROADMAP.md queue 1).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

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

BACKENDS = ("auto", "wide", "pallas")


@dataclasses.dataclass(frozen=True)
class Backend:
    name: str
    chunks: list[WideChunk]
    #: (T, 16) packed per-triangle shading table (scene.shade).
    shade: torch.Tensor | None = None

    def intersect(self, o, d, scene: Scene, alive=None) -> Hit:
        """Closest hit. `alive`: optional lane mask — dead lanes skip the
        walk (t_far = 0) and report the canonical miss."""
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
            s_t, s_prim = sphere_pass(
                o, d, scene.spheres.center, scene.spheres.radius, T_MIN, best_t
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
        """True where a primitive is hit at T_MIN <= t < t_far."""
        blocked = traverse_anyhit_wide(o, d, self.chunks, t_far)
        if scene.n_spheres > 0:
            s_t, _ = sphere_pass(
                o, d, scene.spheres.center, scene.spheres.radius, T_MIN, t_far
            )
            blocked = blocked | (s_t < t_far)
        return blocked


def make_backend(name: str, scene: Scene) -> Backend:
    """Build the backend's acceleration data on the host and place it on
    the scene's device. Production constants of `blink`'s pallas backend:
    340k-triangle Morton chunks, wide leaves of 44, quantized child boxes,
    chunks near to far from the build-time camera origin."""
    if name not in BACKENDS:
        if name in ("brute", "bvh"):
            raise NotImplementedError(
                f"backend '{name}' is not ported yet (ROADMAP.md queue 1)"
            )
        raise KeyError(f"unknown backend '{name}'; choices: {BACKENDS}")
    if scene.n_triangles == 0:
        raise NotImplementedError(
            "scenes without triangles need the brute backend, not ported yet "
            "(ROADMAP.md queue 1)"
        )
    device = scene.device
    if scene.n_spheres > 0 and device.type == "cuda":
        raise NotImplementedError(
            "spheres on a CUDA device need the sphere kernel, still to be "
            "ported (ROADMAP.md queue 2)"
        )
    cam_o = scene.camera.origin.cpu().numpy().astype(np.float32)
    chunks = build_chunked_wide(
        scene.triangles, chunk_tris=340_000, wide_leaf=44, order_from=cam_o
    )
    return Backend(
        name="wide",
        chunks=[WideChunk.from_host(c, device) for c in chunks],
        shade=torch.as_tensor(pack_tri_shade_np(scene.triangles)).to(device),
    )
