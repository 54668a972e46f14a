"""Two-level BVH: a TLAS over per-object BLAS with instance transforms
(counterpart of `blink.bvh.tlas`).

Structure:
  - B unique objects, each with its own flat BLAS (bvh.build.build_flat_bvh,
    in object space), stacked into (B, ...) tensors padded to the largest
    object so that a walk indexes them uniformly;
  - I instances, each an object id and an object -> world affine; the TLAS
    is a skip-link box tree (bvh.build.build_boxtree) over the instances'
    world-space boxes;
  - the walk: the TLAS marks each ray's candidate instances, then each
    candidate's BLAS is walked with the ray in object space. An affine map
    keeps the ray parameter (M(o + t d) = M(o) + t L(d)), so object-space t
    compares directly with the world-space best.

`prim` is tri_offset[instance] + the object-local triangle id: the index of
the triangle in instance_scene_triangles' flattened array, so refine and
the flat walks see the same ids.

`traverse_two_level` is the structural reference for instanced scenes,
plain torch on any device, with a Python loop over instances.

The `tlas` backend walks another layout of the same idea (TlasBVH,
build_tlas): each object's BLAS is a production wide chunk
(build_chunked_wide: quantized 8-wide nodes, wide leaves of 44), and the
TLAS is an 8-wide quantized tree from the same builders over the
instances' world boxes, one instance a leaf child. kernels.traverse_tlas
walks it: csrc/wide_walk.cu's tlas_wide_group_walk on a CUDA device, its
plain version on the CPU.
"""
from __future__ import annotations

import dataclasses

import types

import numpy as np
import torch

from blink_torch.bvh.build import EMPTY_BOX, build_boxtree, build_flat_bvh
from blink_torch.bvh.sah import build_sah_bvh
from blink_torch.bvh.wide import WIDE_STACK_CAP, build_wide
from blink_torch.kernels.traverse_wide import WideChunk, _slab, build_chunked_wide
from blink_torch.kernels.triangle import triangle_t
from blink_torch.kernels.types import T_MAX, T_MIN
from blink_torch.scene.scene import Instances, Triangles


@dataclasses.dataclass(frozen=True)
class TwoLevelBVH:
    # TLAS node arrays (preorder skip links; leaves reference instances).
    tlo: torch.Tensor  # (N, 3) f32
    thi: torch.Tensor  # (N, 3) f32
    tskip: torch.Tensor  # (N,) i32
    tfirst: torch.Tensor  # (N,) i32
    tcount: torch.Tensor  # (N,) i32
    inst_slot: torch.Tensor  # (Ipad,) i32 instance of each TLAS leaf slot (-1 padding)
    # Stacked BLAS arrays, leading dim the object (padded to the largest).
    blo: torch.Tensor  # (B, Nb, 3) f32
    bhi: torch.Tensor  # (B, Nb, 3) f32
    bskip: torch.Tensor  # (B, Nb) i32
    bfirst: torch.Tensor  # (B, Nb) i32
    bcount: torch.Tensor  # (B, Nb) i32
    btv0: torch.Tensor  # (B, Pb, 3) f32
    bte1: torch.Tensor  # (B, Pb, 3) f32
    bte2: torch.Tensor  # (B, Pb, 3) f32
    btid: torch.Tensor  # (B, Pb) i32
    # Instances.
    obj_of_inst: torch.Tensor  # (I,) i32
    w2o: torch.Tensor  # (I, 3, 4) f32 world -> object affine
    tri_offset: torch.Tensor  # (I,) i32 global triangle id of each instance's first
    tlas_leaf_size: int = 2
    blas_leaf_size: int = 4

    def to(self, device) -> "TwoLevelBVH":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    @property
    def nbytes(self) -> int:
        """Bytes of all the structure's tensors."""
        return sum(v.numel() * v.element_size() for v in vars(self).values()
                   if isinstance(v, torch.Tensor))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _mesh_aabb_corners(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    xs = [lo[0], hi[0]]
    ys = [lo[1], hi[1]]
    zs = [lo[2], hi[2]]
    return np.array([[x, y, z] for x in xs for y in ys for z in zs], np.float32)


def build_two_level(object_tris: list, obj_of_inst, o2w, blas_leaf_size: int = 4,
                    tlas_leaf_size: int = 2) -> TwoLevelBVH:
    """The TLAS and the stacked BLAS, on the host (CPU tensors; `.to` moves
    them). object_tris: a list of object-space Triangles; obj_of_inst (I,)
    ints; o2w (I, 3, 4) object -> world affines."""
    blases = [build_flat_bvh(_np(t.verts), _np(t.idx), blas_leaf_size) for t in object_tris]
    nb = max(b.n_nodes for b in blases)
    pb = max(b.tri_id.shape[0] for b in blases)

    def stack(attr: str, fill, width: int) -> np.ndarray:
        outs = []
        for b in blases:
            a = np.asarray(getattr(b, attr))
            padlen = width - a.shape[0]
            if padlen:
                a = np.concatenate([a, np.full((padlen,) + a.shape[1:], fill, a.dtype)])
            outs.append(a)
        return np.stack(outs)

    blo = stack("lo", EMPTY_BOX, nb)
    bhi = stack("hi", EMPTY_BOX, nb)
    # Padding nodes skip to the end, so a stray visit ends the walk.
    bskip = stack("skip", nb, nb)
    bfirst = stack("first", 0, nb)
    bcount = stack("count", 0, nb)
    btv0 = stack("tv0", 0.0, pb)
    bte1 = stack("te1", 0.0, pb)
    bte2 = stack("te2", 0.0, pb)
    btid = stack("tri_id", -1, pb)

    # World-space instance boxes (the 8 corners of the BLAS root, mapped).
    obj_of_inst = _np(obj_of_inst)
    o2w = _np(o2w)
    n_inst = len(obj_of_inst)
    ilo = np.zeros((n_inst, 3), np.float32)
    ihi = np.zeros((n_inst, 3), np.float32)
    w2o = np.zeros((n_inst, 3, 4), np.float32)
    tri_offset = np.zeros((n_inst,), np.int64)
    offset = 0
    for i in range(n_inst):
        b = blases[int(obj_of_inst[i])]
        corners = _mesh_aabb_corners(np.asarray(b.lo[0]), np.asarray(b.hi[0]))
        m = np.asarray(o2w[i], np.float32)
        wc = corners @ m[:, :3].T + m[:, 3]
        ilo[i] = wc.min(axis=0)
        ihi[i] = wc.max(axis=0)
        rinv = np.linalg.inv(m[:, :3])
        w2o[i, :, :3] = rinv
        w2o[i, :, 3] = -rinv @ m[:, 3]
        tri_offset[i] = offset
        offset += int(object_tris[int(obj_of_inst[i])].idx.shape[0])

    tlo, thi, tskip, tfirst, tcount, order, _ = build_boxtree(ilo, ihi, tlas_leaf_size)
    n_leaves = -(-n_inst // tlas_leaf_size)
    ipad = (1 << max(int(np.ceil(np.log2(max(n_leaves, 1)))), 0)) * tlas_leaf_size
    inst_slot = np.full((ipad,), -1, np.int64)
    inst_slot[:n_inst] = order

    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))  # noqa: E731
    return TwoLevelBVH(
        tlo=f32(tlo), thi=f32(thi), tskip=i32(tskip), tfirst=i32(tfirst), tcount=i32(tcount),
        inst_slot=i32(inst_slot),
        blo=f32(blo), bhi=f32(bhi), bskip=i32(bskip), bfirst=i32(bfirst), bcount=i32(bcount),
        btv0=f32(btv0), bte1=f32(bte1), bte2=f32(bte2), btid=i32(btid),
        obj_of_inst=i32(obj_of_inst), w2o=f32(w2o), tri_offset=i32(tri_offset),
        tlas_leaf_size=tlas_leaf_size, blas_leaf_size=blas_leaf_size,
    )


def instance_scene_triangles(object_tris: list, obj_of_inst, o2w) -> Triangles:
    """The flattened world-space Triangles (for the Scene and the flat
    walks): instance i's triangles hold global ids [tri_offset[i], + T_obj)."""
    obj_of_inst, o2w = _np(obj_of_inst), _np(o2w)
    verts, idx, uv, mat = [], [], [], []
    nv = 0
    for i in range(len(obj_of_inst)):
        t = object_tris[int(obj_of_inst[i])]
        v = _np(t.verts).astype(np.float32)
        m = np.asarray(o2w[i], np.float32)
        verts.append(v @ m[:, :3].T + m[:, 3])
        idx.append(_np(t.idx) + nv)
        uv.append(_np(t.uv))
        mat.append(_np(t.material_id))
        nv += v.shape[0]
    return Triangles(
        verts=torch.from_numpy(np.concatenate(verts).astype(np.float32)),
        idx=torch.from_numpy(np.concatenate(idx).astype(np.int32)),
        uv=torch.from_numpy(np.concatenate(uv).astype(np.float32)),
        material_id=torch.from_numpy(np.concatenate(mat).astype(np.int32)),
    )


def _box_hit(o, ix, t_min: float, t_max, lo, hi) -> torch.Tensor:
    """The slab test of the wide walks (traverse_wide._slab) on one box a
    ray: o, ix, lo, hi (M, 3), t_max (M,) -> (M,) bool."""
    return _slab(o[:, None], ix[:, None], t_min, t_max[:, None], lo[:, None], hi[:, None])[:, 0]


def _affine(m, x, translate: bool) -> torch.Tensor:
    """m[:, :3] @ x (+ m[:, 3]) for rows x (M, 3), written out term by term."""
    y = x[:, 0:1] * m[:, 0] + x[:, 1:2] * m[:, 1] + x[:, 2:3] * m[:, 2]
    return y + m[:, 3] if translate else y


def _tlas_candidates(o, ix, acc: TwoLevelBVH, t_min: float) -> torch.Tensor:
    """(N, I) bool: the instances whose world box each ray's TLAS walk
    reaches (a skip-link walk over the instance boxes, rays in step)."""
    n, dev = o.shape[0], o.device
    n_inst = acc.obj_of_inst.shape[0]
    n_tlas = acc.tskip.shape[0]
    k = torch.arange(acc.tlas_leaf_size, device=dev)
    reached = torch.zeros((n, n_inst), dtype=torch.int32, device=dev)
    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    act = torch.arange(n, device=dev)
    t_max = torch.full((n,), T_MAX, dtype=o.dtype, device=dev)
    while act.numel():
        nd = node[act]
        hit = _box_hit(o[act], ix[act], t_min, t_max[act], acc.tlo[nd], acc.thi[nd])
        cnt = acc.tcount[nd]
        # The leaf's slots (M, K), masked to hit leaves and their count.
        inst = acc.inst_slot[acc.tfirst[nd].long()[:, None] + k].long()
        on = (hit & (cnt > 0))[:, None] & (k < cnt[:, None]) & (inst >= 0)
        reached.index_put_((act[:, None].expand_as(inst), inst.clamp(min=0)),
                           on.to(torch.int32), accumulate=True)
        node[act] = torch.where(hit, nd + 1, acc.tskip[nd].long())
        act = act[node[act] < n_tlas]
    return reached > 0


def _walk_blas(o, d, acc: TwoLevelBVH, obj: int, t_min: float, best_t):
    """One object's BLAS walked by the object-space rays (o, d) (M, 3) of
    its candidate lanes, from their best t so far (a skip-link walk, rays
    in step). A leaf's K slots are tested together; the first of equal
    minima wins and must beat the best t strictly, as blink's slot loop.
    Returns (t, local id, found) with found where a nearer triangle was
    hit."""
    nb = acc.bskip.shape[1]
    ix = 1.0 / d
    k = torch.arange(acc.blas_leaf_size, device=o.device)
    lo, hi, skip = acc.blo[obj], acc.bhi[obj], acc.bskip[obj].long()
    first, count = acc.bfirst[obj].long(), acc.bcount[obj]
    tv0, te1, te2, tid = acc.btv0[obj], acc.bte1[obj], acc.bte2[obj], acc.btid[obj]
    m = o.shape[0]
    bt = best_t.clone()
    bp = torch.full((m,), -1, dtype=torch.int32, device=o.device)
    node = torch.zeros((m,), dtype=torch.int64, device=o.device)
    act = torch.arange(m, device=o.device)
    while act.numel():
        nd = node[act]
        t_a = bt[act]
        hit = _box_hit(o[act], ix[act], t_min, t_a, lo[nd], hi[nd])
        cnt = count[nd]
        s = first[nd][:, None] + k  # (M, K) slots of the node's leaf
        t = triangle_t(o[act][:, None], d[act][:, None], tv0[s], te1[s], te2[s], t_min,
                       t_a[:, None])
        t = torch.where((hit & (cnt > 0))[:, None] & (k < cnt[:, None]), t, T_MAX)
        t_j, j = torch.min(t, dim=1)
        better = t_j < t_a
        bt[act] = torch.where(better, t_j, t_a)
        bp[act] = torch.where(better, tid[s.gather(1, j[:, None]).squeeze(1)], bp[act])
        node[act] = torch.where(hit, nd + 1, skip[nd])
        act = act[node[act] < nb]
    return bt, bp, bp >= 0


@torch.no_grad()
def traverse_two_level(o, d, acc: TwoLevelBVH, t_min: float = T_MIN):
    """Closest hit over the two-level structure: (t (N,) f32, global prim
    (N,) i32), prim -1 on a miss. The TLAS marks each ray's candidate
    instances; then instance by instance, the BLAS walk runs on the
    candidate lanes alone, the rays in object space and the best t
    threaded through, so an instance that no ray reaches costs nothing."""
    n, dev = o.shape[0], o.device
    mask = _tlas_candidates(o, 1.0 / d, acc, t_min)
    best_t = torch.full((n,), T_MAX, dtype=o.dtype, device=dev)
    best_prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    objs = acc.obj_of_inst.tolist()
    offsets = acc.tri_offset.tolist()
    for i in torch.nonzero(mask.any(0)).squeeze(1).tolist():
        lanes = torch.nonzero(mask[:, i]).squeeze(1)
        m = acc.w2o[i]
        bt, bp, found = _walk_blas(_affine(m, o[lanes], True), _affine(m, d[lanes], False),
                                   acc, objs[i], t_min, best_t[lanes])
        best_t[lanes] = torch.where(found, bt, best_t[lanes])
        best_prim[lanes] = torch.where(found, bp + offsets[i], best_prim[lanes])
    return best_t, best_prim


# --------------------------------------------------------------------------
# The `tlas` backend's structure: a wide TLAS over wide BLAS chunks
# (kernels.traverse_tlas walks it).
# --------------------------------------------------------------------------

#: The BLAS of each object: build_chunked_wide's production constants, one
#: chunk an object.
BLAS_CHUNK_TRIS = 340_000
BLAS_WIDE_LEAF = 44


@dataclasses.dataclass(frozen=True)
class TlasBVH:
    """The two-level structure the `tlas` backend walks (csrc/wide_walk.cu's
    tlas_wide_group_walk has the layouts). `top` is the TLAS: a quantized
    wide chunk over the instances' world boxes whose tri_id names the
    instance of each leaf record. The BLAS tables of all objects lie end to
    end: object b owns wide nodes [node_off[b], node_off[b + 1]) and records
    [rec_off[b], rec_off[b + 1]), indexed locally inside."""

    top: WideChunk
    child: torch.Tensor  # (sum n_wide * 24,) i32
    nbox: torch.Tensor  # (sum n_wide * 8,) f32
    perm: torch.Tensor  # (sum n_wide * 8,) i32
    tri: torch.Tensor  # (sum P, 12) f32
    tri_id: torch.Tensor  # (sum P,) i32 object-local triangle ids
    w2o: torch.Tensor  # (I, 3, 4) f32 world -> object affines
    #: (I, 4) i32: the instance's object's first node and first record, its
    #: first global triangle id (tri_offset), its object.
    meta: torch.Tensor
    node_off: tuple
    rec_off: tuple
    blas_stack: tuple  # each object's max_stack

    def to(self, device) -> "TlasBVH":
        moved = {f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, top=WideChunk.from_host(self.top, device), **moved)

    @property
    def n_objects(self) -> int:
        return len(self.node_off) - 1

    def objects(self) -> list[WideChunk]:
        """Each object's BLAS as a WideChunk of views into the tables."""
        out = []
        for b in range(self.n_objects):
            n0, n1 = self.node_off[b], self.node_off[b + 1]
            r0, r1 = self.rec_off[b], self.rec_off[b + 1]
            out.append(WideChunk(child=self.child[24 * n0:24 * n1], nbox=self.nbox[8 * n0:8 * n1],
                                 perm=self.perm[8 * n0:8 * n1], tri=self.tri[r0:r1],
                                 tri_id=self.tri_id[r0:r1], max_stack=self.blas_stack[b]))
        return out

    @property
    def nbytes(self) -> int:
        """Bytes of all the structure's tensors."""
        tensors = [v for v in vars(self).values() if isinstance(v, torch.Tensor)]
        tensors += [v for v in vars(self.top).values() if isinstance(v, torch.Tensor)]
        return sum(v.numel() * v.element_size() for v in tensors)


def instances_of(object_tris: list, obj_of_inst, o2w) -> Instances:
    """The Instances group of a list of object-space Triangles placed by
    obj_of_inst (I,) and o2w (I, 3, 4)."""
    verts, idx, start, nv = [], [], [0], 0
    for t in object_tris:
        v, f = _np(t.verts).astype(np.float32), _np(t.idx).astype(np.int64)
        verts.append(v)
        idx.append(f + nv)
        nv += v.shape[0]
        start.append(start[-1] + f.shape[0])
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))  # noqa: E731
    return Instances(verts=torch.from_numpy(np.concatenate(verts)), idx=i32(np.concatenate(idx)),
                     tri_start=i32(start), obj_of_inst=i32(_np(obj_of_inst)),
                     o2w=torch.from_numpy(np.ascontiguousarray(_np(o2w), np.float32)))


def _round_out(lo64: np.ndarray, hi64: np.ndarray):
    """float64 bounds to the f32 box that holds them."""
    lo, hi = lo64.astype(np.float32), hi64.astype(np.float32)
    lo = np.where(lo > lo64, np.nextafter(lo, np.float32(-np.inf)), lo)
    hi = np.where(hi < hi64, np.nextafter(hi, np.float32(np.inf)), hi)
    return lo.astype(np.float32), hi.astype(np.float32)


def build_tlas(inst: Instances) -> TlasBVH:
    """The `tlas` backend's structure, on the host (CPU tensors; `.to` moves
    it). Each object's BLAS is built once, in object space, by
    build_chunked_wide with the production constants; the TLAS is an SAH
    tree with one instance a leaf, collapsed by build_wide (quantized, wide
    leaves of 1), over the instances' world boxes: the bounds of their
    objects' vertices mapped by o2w in float64, rounded outwards."""
    verts = _np(inst.verts).astype(np.float32)
    idx = _np(inst.idx).astype(np.int64)
    start = _np(inst.tri_start).astype(np.int64)
    obj_of_inst = _np(inst.obj_of_inst).astype(np.int64)
    o2w = _np(inst.o2w).astype(np.float32)
    n_obj, n_inst = start.shape[0] - 1, obj_of_inst.shape[0]
    if n_inst == 0 or n_obj == 0:
        raise ValueError("the tlas backend needs at least one object and one instance")
    if obj_of_inst.min() < 0 or obj_of_inst.max() >= n_obj:
        raise ValueError(f"obj_of_inst names an object outside [0, {n_obj})")

    blas, obj_verts = [], []
    for b in range(n_obj):
        f = idx[start[b]:start[b + 1]]
        if f.shape[0] == 0:
            raise ValueError(f"object {b} has no triangles")
        chunks = build_chunked_wide(
            types.SimpleNamespace(verts=torch.from_numpy(verts), idx=torch.from_numpy(f)),
            chunk_tris=BLAS_CHUNK_TRIS, wide_leaf=BLAS_WIDE_LEAF, quant=True, row_tables=False)
        if len(chunks) != 1:
            raise ValueError(f"object {b} has more than {BLAS_CHUNK_TRIS} triangles")
        blas.append(chunks[0])
        obj_verts.append(verts[np.unique(f)].astype(np.float64))
    node_off = np.cumsum([0] + [c.n_wide for c in blas])
    rec_off = np.cumsum([0] + [c.tri.shape[0] for c in blas])

    # World boxes of the instances, and their w2o and meta rows.
    ilo = np.zeros((n_inst, 3), np.float64)
    ihi = np.zeros((n_inst, 3), np.float64)
    w2o = np.zeros((n_inst, 3, 4), np.float32)
    meta = np.zeros((n_inst, 4), np.int64)
    n_tris = start[1:] - start[:-1]
    tri_offset = np.cumsum(np.concatenate([[0], n_tris[obj_of_inst]]))[:-1]
    for i in range(n_inst):
        b = int(obj_of_inst[i])
        m = o2w[i].astype(np.float64)
        wv = obj_verts[b] @ m[:, :3].T + m[:, 3]
        ilo[i], ihi[i] = wv.min(axis=0), wv.max(axis=0)
        rinv = np.linalg.inv(m[:, :3])
        w2o[i, :, :3] = rinv
        w2o[i, :, 3] = -rinv @ m[:, 3]
        meta[i] = (node_off[b], rec_off[b], tri_offset[i], b)
    if tri_offset[-1] + n_tris[obj_of_inst[-1]] >= 2**31:
        raise ValueError("more than 2**31 - 1 instanced triangles")
    lo, hi = _round_out(ilo, ihi)
    # One "triangle" an instance, (lo, hi, mid), whose bounds and centroid are
    # the box's: the SAH build and the collapse then see the boxes.
    mid = (0.5 * (lo.astype(np.float64) + hi)).astype(np.float32)
    box_tris = np.stack([lo, hi, mid], axis=1).reshape(-1, 3)
    top = build_wide(build_sah_bvh(box_tris, np.arange(3 * n_inst).reshape(-1, 3), 1),
                     wide_leaf=1, quant=True, row_tables=False)
    if top.max_stack + max(c.max_stack for c in blas) > WIDE_STACK_CAP:
        raise ValueError(f"TLAS stack {top.max_stack} and BLAS stack "
                         f"{max(c.max_stack for c in blas)} exceed {WIDE_STACK_CAP}")

    cat = lambda attr: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        np.concatenate([getattr(c, attr) for c in blas])))
    return TlasBVH(
        top=WideChunk.from_host(top, "cpu"), child=cat("child"), nbox=cat("nbox"),
        perm=cat("perm"), tri=cat("tri"), tri_id=cat("tri_id"),
        w2o=torch.from_numpy(w2o), meta=torch.from_numpy(meta.astype(np.int32)),
        node_off=tuple(int(x) for x in node_off), rec_off=tuple(int(x) for x in rec_off),
        blas_stack=tuple(c.max_stack for c in blas))
