"""Backend: the traversal implementation and its acceleration data
(counterpart of `blink.kernels.api`).

  brute — every ray against every primitive, plain torch (the oracle; any
          scene, O(rays x primitives));
  bvh   — one flat Morton BVH (leaves of 16) walked by the skip-link rule
          `node = hit ? node+1 : skip[node]`: the skip-link CUDA kernels on
          a CUDA device, their plain torch versions on the CPU;
  wide  — the chunked, quantized 8-wide BVH (`pallas` in `blink`, accepted
          as an alias): the CUDA walks on a CUDA device, their plain torch
          versions on the CPU. The leaf mode resolves per call through
          `traverse_wide._default_leaf_mode` (BLINK_LEAF_MODE): the
          production chunks carry no row tables, so they always walk
          'group'; a Backend built over chunks with row tables (bref/tbat)
          honours BLINK_LEAF_MODE=row|stream;
  tlas  — the two-level BVH of the scene's `instances` (bvh.tlas): a wide
          TLAS over the instances, each object's BLAS a production wide
          chunk; kernels.traverse_tlas walks it (tlas_wide_group_walk on
          a CUDA device, its plain torch version on the CPU). Prims are
          the flattened triangles' ids, so everything after the walk is
          wide's;
  auto  — brute at 64 triangles or fewer, else wide (`blink`'s rule).

Spheres go through `sphere_merge` (closest hit) and `sphere_pass`
(occlusion) on bvh, wide and tlas (the sphere kernel on a CUDA device).
Traversal is a topology oracle: every input is detached and no output
carries a gradient; gradients come from diff.hitrefine.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from blink_torch.bvh import tlas as tl
from blink_torch.bvh.build import build_flat_bvh
from blink_torch.kernels.bruteforce import intersect_brute, occluded_brute
from blink_torch.kernels.sphere import sphere_merge, sphere_pass
from blink_torch.kernels.traverse_packed import (
    PackedBVH,
    pack_bvh_planes,
    traverse_anyhit_packed,
    traverse_closest_packed,
)
from blink_torch.kernels.traverse_tlas import (
    COUNTERS,
    traverse_anyhit_tlas,
    traverse_closest_tlas,
    walk_counts,
)
from blink_torch.kernels.traverse_wide import (
    WideChunk,
    build_chunked_wide,
    traverse_anyhit_wide,
    traverse_closest_wide,
)
from blink_torch.kernels.types import KIND_NONE, KIND_TRI, T_MAX, T_MIN, Hit
from blink_torch.obs import profile
from blink_torch.scene.scene import Scene
from blink_torch.scene.shade import pack_tri_shade_np

BACKENDS = ("auto", "brute", "bvh", "wide", "pallas", "tlas")

#: `auto` picks brute up to this many triangles.
BRUTE_MAX_TRIS = 64


@dataclasses.dataclass(frozen=True)
class Backend:
    name: str  # "brute" | "bvh" | "wide" | "tlas"
    #: wide: the WideChunks; bvh: one PackedBVH.
    chunks: list[WideChunk] | list[PackedBVH] | None = None
    #: (T, 16) packed per-triangle shading table (scene.shade). None:
    #: render_image packs it in the graph from the live scene.
    shade: torch.Tensor | None = None
    #: tlas: the two-level structure.
    tlas: tl.TlasBVH | None = None

    def intersect(self, o, d, scene: Scene, alive=None) -> Hit:
        """Closest hit. `alive`: optional lane mask — dead lanes report the
        canonical miss, and on wide skip the walk (t_far = 0)."""
        with profile.span("closest"):
            if profile.recording():
                n = o.shape[0]
                profile.count("walk_lanes.closest", n)
                profile.count("walk_live.closest", n if alive is None else alive.sum())
            return self._intersect(o, d, scene, alive)

    def _intersect(self, o, d, scene: Scene, alive) -> Hit:
        o, d = o.detach().contiguous(), d.detach().contiguous()
        if self.name == "brute":
            return intersect_brute(o, d, scene, alive=alive)
        if self.name == "bvh":
            best_t, tri_prim = traverse_closest_packed(o, d, self.chunks, variant="skip")
            if alive is not None:
                tri_prim = torch.where(alive, tri_prim, -1)
        elif self.name == "tlas":
            tf = None if alive is None else torch.where(alive, T_MAX, 0.0).to(torch.float32)
            _count_tlas(False, o, d, self.tlas, tf)
            best_t, tri_prim = traverse_closest_tlas(o, d, self.tlas, t_far=tf)
        else:
            tf = None
            if alive is not None:
                tf = torch.where(alive, T_MAX, 0.0).to(torch.float32)
            best_t, tri_prim = traverse_closest_wide(o, d, self.chunks, t_far=tf,
                                                     leaf_mode=None)
        kind = torch.where(tri_prim >= 0, KIND_TRI, KIND_NONE).to(torch.int32)
        prim = torch.clamp(tri_prim, min=0)
        if scene.n_spheres > 0:
            if alive is not None:
                # Dead lanes must not pick up sphere hits.
                best_t = torch.where(alive, best_t, 0.0)
            sph = scene.spheres
            best_t, kind, prim = sphere_merge(
                o, d, sph.center.detach(), sph.radius.detach(), T_MIN, best_t, kind, prim
            )
        if alive is not None:
            # Canonical dead-lane Hit, identical across backends.
            best_t = torch.where(alive, best_t, T_MAX)
            kind = torch.where(alive, kind, KIND_NONE).to(torch.int32)
            prim = torch.where(alive, prim, 0)
        return Hit(t=best_t, kind=kind, prim=prim)

    def occluded(self, o, d, scene: Scene, t_far) -> torch.Tensor:
        """True where a primitive is hit at T_MIN <= t < t_far (brute: up to
        and including t_far, as `blink`'s brute backend)."""
        with profile.span("shadow"):
            t_far = t_far.detach().to(torch.float32).contiguous()
            if profile.recording():
                profile.count("walk_lanes.anyhit", t_far.shape[0])
                profile.count("walk_live.anyhit", (t_far > 0).sum())
            return self._occluded(o, d, scene, t_far)

    def _occluded(self, o, d, scene: Scene, t_far) -> torch.Tensor:
        o, d = o.detach().contiguous(), d.detach().contiguous()
        if self.name == "brute":
            return occluded_brute(o, d, scene, t_far)
        if self.name == "bvh":
            blocked = traverse_anyhit_packed(o, d, self.chunks, t_far, variant="skip")
        elif self.name == "tlas":
            _count_tlas(True, o, d, self.tlas, t_far)
            blocked = traverse_anyhit_tlas(o, d, self.tlas, t_far)
        else:
            blocked = traverse_anyhit_wide(o, d, self.chunks, t_far, leaf_mode=None)
        if scene.n_spheres > 0:
            sph = scene.spheres
            s_t, _ = sphere_pass(
                o, d, sph.center.detach(), sph.radius.detach(), T_MIN, t_far
            )
            blocked = blocked | (s_t < t_far)
        return blocked


#: The tlas walk's counters are taken on every TLAS_SAMPLE-th lane of a
#: call: odd, so that the sample steps through the samples a pixel that
#: render packs side by side.
TLAS_SAMPLE = 61


def _count_tlas(any_hit: bool, o, d, acc: tl.TlasBVH, t_far) -> None:
    """While a profiler records, the call's counters tlas_pops, blas_pops,
    tri_tests and blas_entries (BLAS walks begun), each .closest or
    .anyhit: every TLAS_SAMPLE-th lane is copied now (one launch) and
    walked by walk_counts when the counters are read, after the recording,
    so the recorded walk is the production build; the sums are scaled to
    the call's lanes."""
    n = o.shape[0]
    if not profile.recording() or n == 0:
        return
    s = slice(None, None, TLAS_SAMPLE)
    bounded = t_far is not None
    lanes = torch.cat([o[s], d[s]] + ([t_far[s, None]] if bounded else []), 1)

    def later():
        tf = lanes[:, 6] if bounded else None
        _, c = walk_counts(any_hit, lanes[:, 0:3], lanes[:, 3:6], acc, tf)
        m = lanes.shape[0]
        return list(torch.div(c * n + m // 2, m, rounding_mode="floor"))

    kind = "anyhit" if any_hit else "closest"
    profile.count_later([f"{name}.{kind}" for name in COUNTERS], later)


def make_backend(name: str, scene: Scene) -> Backend:
    """Build the backend's acceleration data on the host and place it on
    the scene's device. bvh: `blink`'s build_flat_bvh (Morton, leaves of
    16). wide: the production constants of `blink`'s pallas backend:
    340k-triangle Morton chunks, wide leaves of 44, quantized child boxes
    without row tables, chunks near to far from the build-time camera
    origin. tlas: bvh.tlas.build_tlas of the scene's `instances`."""
    if name not in BACKENDS:
        raise KeyError(f"unknown backend '{name}'; choices: {BACKENDS}")
    if name == "auto":
        name = "brute" if scene.n_triangles <= BRUTE_MAX_TRIS else "wide"
    if name == "brute":
        return Backend(name="brute")
    if scene.n_triangles == 0:
        raise ValueError(f"the {name} backend needs triangles; use 'brute'")
    if name == "tlas" and scene.instances is None:
        raise ValueError("the tlas backend needs the scene's `instances` group "
                         "(Scene.instances); this scene has none")
    device = scene.device
    shade = torch.as_tensor(pack_tri_shade_np(scene.triangles)).to(device)
    if name == "tlas":
        return Backend(name="tlas", shade=shade, tlas=tl.build_tlas(scene.instances).to(device))
    if name == "bvh":
        tris = scene.triangles
        flat = build_flat_bvh(tris.verts.detach().cpu().numpy(), tris.idx.cpu().numpy())
        return Backend(name="bvh", chunks=[pack_bvh_planes(flat).to(device)], shade=shade)
    cam_o = scene.camera.origin.detach().cpu().numpy().astype(np.float32)
    chunks = build_chunked_wide(
        scene.triangles, chunk_tris=340_000, wide_leaf=44, quant=True,
        row_tables=False, order_from=cam_o,
    )
    return Backend(
        name="wide",
        chunks=[WideChunk.from_host(c, device) for c in chunks],
        shade=shade,
    )
