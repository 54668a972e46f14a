"""Binary-BVH traversal: closest hit and any hit over one flat BVH or a list
of chunks, by the skip-link walk or the ordered walk (counterpart of the
binary half of `blink.kernels.traverse_pallas`: `pack_bvh_planes`,
`_make_kernel`, `_make_kernel_ordered`, `_make_kernel_ordered_rg`,
`build_chunked_packed`, `traverse_closest_pallas`, `traverse_anyhit_pallas`
and the packed branch of `traverse_closest_chunked` and
`traverse_anyhit_chunked`).

On a CUDA tensor, `traverse_closest_packed` and `traverse_anyhit_packed`
launch the hand-written kernels of `csrc/binary_walk.cu`, one launch per
chunk, or raise. On a CPU tensor they run the plain torch versions,
`skip_walk_plain` and `ordered_walk_plain`, which step every ray one node
at a time with the kernels' arithmetic and visit order, so the two agree
bit for bit.

The walks, per ray and chunk (best t starts at min(t_far, T_MAX)):
  skip    — node = need ? node+1 : skip[node] from the root until
            node == n_nodes; `need` is the slab test against the best t;
  ordered — pop a node; if needed, test a leaf's triangles, or replace an
            internal node by its far child with the near child on top. The
            near child is the left one iff (d[axis] >= 0) XOR !lower_first,
            from the ray's own direction (blink takes the sign of the sum
            over a 4096-ray packet). Order decides only which of two
            exactly tied triangles wins.
Leaf triangles are tested in slot order: a hit with t_min <= t <= best and
t < best replaces the best. Any hit stops at its first hit, so a hit
exactly at t_far does not block. Chunks run in list order and thread the
best t, or the blocked flags (a blocked ray skips later chunks, as
`blink`'s t_far = 0 does).

The layout keeps `blink`'s tables as int32 and float32 rows instead of
floats in 16-lane slots (that layout exists because Mosaic cannot index
lanes dynamically); the metadata the ordered walk reads is `blink`'s.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from blink_torch.bvh.build import EMPTY_BOX
from blink_torch.bvh.types import FlatBVH
from blink_torch.kernels._build import check_arg
from blink_torch.kernels.traverse_wide import CHUNK_TRIS, _chunked_sah_trees, _slab
from blink_torch.kernels.triangle import triangle_t
from blink_torch.kernels.types import T_MAX, T_MIN

#: Traversal-stack capacity of the ordered walk (blink's SMEM stack).
STACK_CAP = 64
#: Closest-hit variant by default (`blink`'s CLOSEST_VARIANT). "ordered_rg"
#: names blink's row-group kernel, whose culling of 8-row sub-packets has
#: nothing to cull for one ray: it is an alias of "ordered" (`_is_ordered`).
CLOSEST_VARIANT = "ordered_rg"
VARIANTS = ("skip", "ordered", "ordered_rg")

#: Columns of PackedBVH.node.
SKIP, FIRST, COUNT, RCHILD, AXIS, LOWER_FIRST = range(6)

#: Kernel launches since the last reset_launches(), by kernel name. Each
#: wrapper adds one where it launches its kernel and nowhere else.
LAUNCHES = {"skip_closest": 0, "skip_anyhit": 0, "ordered_closest": 0,
            "ordered_anyhit": 0}

#: Rays per step of the plain walks, on the CPU and on a CUDA device:
#: bounds their scratch memory (about 2 KB a ray). The walks take as many
#: steps as the longest ray's path, so larger batches take fewer steps.
_PLAIN_BATCH = {"cpu": 1 << 15, "cuda": 1 << 18}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class PackedBVH:
    """One flat binary BVH as tensors on the device that walks it."""

    box: torch.Tensor  # (N, 8) f32: lo.xyz, 0, hi.xyz, 0
    node: torch.Tensor  # (N, 8) i32: skip, first, count, rchild, axis, lower_first, 0, 0
    tri: torch.Tensor  # (P, 12) f32: v0, e1, e2, 0, 0, 0
    tri_id: torch.Tensor  # (P,) i32, -1 for padding slots
    leaf_size: int

    @property
    def n_nodes(self) -> int:
        return self.box.shape[0]

    @property
    def skip(self) -> torch.Tensor:
        return self.node[:, SKIP]

    @property
    def rchild(self) -> torch.Tensor:
        return self.node[:, RCHILD]

    @property
    def axis(self) -> torch.Tensor:
        return self.node[:, AXIS]

    @property
    def lower_first(self) -> torch.Tensor:
        return self.node[:, LOWER_FIRST]

    def to(self, device) -> "PackedBVH":
        return dataclasses.replace(
            self, box=self.box.to(device), node=self.node.to(device),
            tri=self.tri.to(device), tri_id=self.tri_id.to(device))


# --------------------------------------------------------------------------
# Host half (numpy).
# --------------------------------------------------------------------------


def _check_depth(bvh: FlatBVH) -> None:
    """Raise unless the ordered walk's stack (one pending far child per
    ancestor level, plus the node being expanded) fits STACK_CAP. Padding
    nodes (EMPTY_BOX point boxes) never pass a slab test, so the walk never
    descends into them: they are left out of the nesting model, or the
    tail chain of a padded chunk would read as thousands deep."""
    skip = np.asarray(bvh.skip)
    unreachable = ((bvh.lo >= EMPTY_BOX) & (bvh.hi >= EMPTY_BOX)).all(axis=1)
    stack: list[int] = []
    max_depth = 0
    for i in range(bvh.n_nodes):
        while stack and stack[-1] <= i:
            stack.pop()
        max_depth = max(max_depth, len(stack))
        if not unreachable[i]:
            stack.append(int(skip[i]))
    if max_depth + 2 > STACK_CAP:
        raise ValueError(
            f"BVH depth {max_depth} needs stack {max_depth + 2} > "
            f"STACK_CAP={STACK_CAP}; rebuild with a depth-bounded builder"
        )


def pack_bvh_planes(bvh: FlatBVH) -> PackedBVH:
    """The tables of a FlatBVH on the host, with the ordered walk's child
    metadata: rchild (preorder index of the right child, skip[node+1], for
    internal nodes; 0 otherwise), axis (argmax of the absolute difference of
    the two children's box centres) and lower_first (1 if the left child
    lies on the lower side of that axis). Raises if the tree is too deep
    for STACK_CAP."""
    _check_depth(bvh)
    n = bvh.n_nodes
    lo, hi = np.asarray(bvh.lo, np.float32), np.asarray(bvh.hi, np.float32)
    skip, count = np.asarray(bvh.skip), np.asarray(bvh.count)
    center = 0.5 * (lo + hi)
    node = np.arange(n)
    internal = (count == 0) & (skip > node + 1)
    left = np.minimum(node + 1, n - 1)
    rchild = np.where(internal, skip[left], 0)
    rsafe = np.clip(rchild, 0, n - 1)
    diff = center[rsafe] - center[left]
    axis = np.argmax(np.abs(diff), axis=1)
    lower_first = diff[node, axis] >= 0

    box = np.zeros((n, 8), np.float32)
    box[:, 0:3], box[:, 4:7] = lo, hi
    meta = np.zeros((n, 8), np.int32)
    for col, a in ((SKIP, skip), (FIRST, bvh.first), (COUNT, count), (RCHILD, rchild),
                   (AXIS, axis), (LOWER_FIRST, lower_first)):
        meta[:, col] = a
    p = bvh.tri_id.shape[0]
    tri = np.zeros((p, 12), np.float32)
    tri[:, 0:3], tri[:, 3:6], tri[:, 6:9] = bvh.tv0, bvh.te1, bvh.te2
    return PackedBVH(
        box=torch.from_numpy(box), node=torch.from_numpy(meta),
        tri=torch.from_numpy(tri),
        tri_id=torch.from_numpy(np.asarray(bvh.tri_id, np.int32)),
        leaf_size=bvh.leaf_size,
    )


def build_chunked_packed(tris, leaf_size: int = 16,
                         chunk_tris: int = CHUNK_TRIS) -> list[PackedBVH]:
    """One packed SAH BVH per Morton chunk of `chunk_tris` triangles, with
    global triangle ids, on the host (`blink`'s build_chunked_packed)."""
    verts = tris.verts.detach().cpu().numpy()
    idx = tris.idx.cpu().numpy()
    return [pack_bvh_planes(b)
            for b in _chunked_sah_trees(verts, idx, chunk_tris, leaf_size=leaf_size)]


# --------------------------------------------------------------------------
# Plain torch versions.
# --------------------------------------------------------------------------


def _leaf_plain(o, d, pk: PackedBVH, fst, cnt, bt, t_min: float):
    """The leaf tests of M rays, each against the cnt slots from fst of its
    leaf, as the kernel's sequential strict-< merge in slot order. Returns
    (hit, t, slot, first): whether a slot beat bt, the best t, the first
    slot reaching it, and the first slot that beat bt (where any hit
    stops), as a position in the leaf."""
    j = torch.arange(pk.leaf_size, device=o.device)
    slot = fst[:, None] + j
    tr = pk.tri[slot.clamp(max=pk.tri.shape[0] - 1)]
    t = triangle_t(o[:, None], d[:, None], tr[..., 0:3], tr[..., 3:6], tr[..., 6:9],
                   t_min, bt[:, None])
    hit = (j < cnt[:, None]) & (t < bt[:, None])
    # The sequential merge keeps the first slot that reaches the minimum.
    tmin = torch.where(hit, t, torch.inf).amin(1)
    win = (hit & (t == tmin[:, None])).long().argmax(1)
    rows = torch.arange(slot.shape[0], device=o.device)
    return hit.any(1), tmin, slot[rows, win], hit.long().argmax(1)


def _walk_chunk(o, d, pk: PackedBVH, bt, any_hit: bool, t_min: float, ordered: bool,
                pops=None, tests=None, seen=None, trace=None):
    """Walk one chunk for a batch of rays (B,) whose best t (or, for any
    hit, bound) is `bt`, one node per ray and step. Closest hit: updates bt
    in place and returns the winning slot per ray (-1: no better hit in this
    chunk). Any hit: returns the blocked flags. `pops`/`tests` (B,) int64,
    when given, count node visits and triangle tests as the kernel does
    them; `seen`, a pair of bool masks (N,) and (P,), marks the nodes and
    triangle slots read; `trace(act, read)`, when given, is called after
    each step with the rays that stepped (indices into the batch) and the
    triangle tests each made in that step."""
    B = o.shape[0]
    dev = o.device
    n = pk.n_nodes
    ix = 1.0 / d
    meta = pk.node.long()
    cur = torch.zeros(B, dtype=torch.int64, device=dev)
    slot_best = torch.full((B,), -1, dtype=torch.int64, device=dev)
    blocked = torch.zeros(B, dtype=torch.bool, device=dev)
    if ordered:
        dpos = d >= 0  # -0.0 counts as positive
        stack = torch.zeros((B, STACK_CAP), dtype=torch.int64, device=dev)
        sp = torch.ones(B, dtype=torch.int64, device=dev)  # root pushed
    act = torch.arange(B, device=dev)
    while act.numel():
        if ordered:
            sp1 = sp[act] - 1
            nd = stack[act, sp1]
        else:
            nd = cur[act]
        if pops is not None:
            pops[act] += 1
        if seen is not None:
            seen[0][nd] = True
        bx, m = pk.box[nd], meta[nd]
        need = _slab(o[act], ix[act], t_min, bt[act], bx[:, 0:3], bx[:, 4:7])
        cnt = m[:, COUNT]
        done = torch.zeros(act.numel(), dtype=torch.bool, device=dev)
        li = torch.nonzero(need & (cnt > 0)).squeeze(1)
        read = torch.zeros(act.numel(), dtype=torch.int64, device=dev)
        if li.numel():
            r = act[li]
            hit, tmin, wslot, first = _leaf_plain(o[r], d[r], pk, m[li, FIRST], cnt[li],
                                                  bt[r], t_min)
            read[li] = torch.where(hit, first + 1, cnt[li]) if any_hit else cnt[li]
            if tests is not None:
                tests[r] += read[li]
            if seen is not None:
                j = torch.arange(pk.leaf_size, device=dev)
                slots = m[li, FIRST][:, None] + j
                seen[1][slots[j < read[li, None]]] = True
            if any_hit:
                blocked[r[hit]] = True
                done[li[hit]] = True
            else:
                bt[r[hit]] = tmin[hit]
                slot_best[r[hit]] = wslot[hit]
        if trace is not None:
            trace(act, read)
        if ordered:
            right = m[:, RCHILD]
            near_is_left = ~dpos[act, m[:, AXIS]] ^ (m[:, LOWER_FIRST] > 0)
            left = nd + 1
            push = need & (cnt == 0) & (right > 0)
            pi = torch.nonzero(push).squeeze(1)
            stack[act[pi], sp1[pi]] = torch.where(near_is_left, right, left)[pi]
            stack[act[pi], sp1[pi] + 1] = torch.where(near_is_left, left, right)[pi]
            sp[act] = torch.where(done, 0, torch.where(push, sp1 + 2, sp1))
            act = act[sp[act] > 0]
        else:
            cur[act] = torch.where(need, nd + 1, m[:, SKIP])
            act = act[(cur[act] < n) & ~done]
    return blocked if any_hit else slot_best


def _as_list(bvh) -> list[PackedBVH]:
    return [bvh] if isinstance(bvh, PackedBVH) else list(bvh)


def _seen_masks(c: PackedBVH, seen):
    """A (nodes, slots) pair of bool masks for chunk c, appended to `seen`;
    None when `seen` is None."""
    if seen is None:
        return None
    dev = c.box.device
    masks = (torch.zeros(c.n_nodes, dtype=torch.bool, device=dev),
             torch.zeros(c.tri.shape[0], dtype=torch.bool, device=dev))
    seen.append(masks)
    return masks


def _closest_plain(o, d, chunks, t_far, t_min, ordered, counts, seen=None):
    chunks = _as_list(chunks)
    n = o.shape[0]
    dev = o.device
    t = torch.full((n,), T_MAX, dtype=torch.float32, device=dev)
    if t_far is not None:
        t = torch.minimum(t_far.to(torch.float32), t)
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    pops = torch.zeros(n, dtype=torch.int64, device=dev)
    tests = torch.zeros(n, dtype=torch.int64, device=dev)
    step = _PLAIN_BATCH[dev.type]
    for c in chunks:
        masks = _seen_masks(c, seen)
        for s in range(0, n, step):
            sl = slice(s, min(n, s + step))
            bt = t[sl].clone()
            slot = _walk_chunk(o[sl], d[sl], c, bt, False, t_min, ordered,
                               pops[sl] if counts else None, tests[sl] if counts else None,
                               masks)
            t[sl] = bt
            prim[sl] = torch.where(slot >= 0, c.tri_id[slot.clamp(min=0)], prim[sl])
    return (t, prim, pops, tests) if counts else (t, prim)


def _anyhit_plain(o, d, chunks, t_far, t_min, ordered, counts, seen=None):
    chunks = _as_list(chunks)
    n = o.shape[0]
    dev = o.device
    bound = torch.clamp(t_far.to(torch.float32), max=T_MAX)
    blocked = torch.zeros(n, dtype=torch.bool, device=dev)
    pops = torch.zeros(n, dtype=torch.int64, device=dev)
    tests = torch.zeros(n, dtype=torch.int64, device=dev)
    step = _PLAIN_BATCH[dev.type]
    for c in chunks:
        masks = _seen_masks(c, seen)
        open_ = torch.nonzero(~blocked).squeeze(1)
        for s in range(0, open_.numel(), step):
            rays = open_[s : s + step]
            p = torch.zeros(rays.numel(), dtype=torch.int64, device=dev)
            q = torch.zeros_like(p)
            hit = _walk_chunk(o[rays], d[rays], c, bound[rays], True, t_min, ordered,
                              p if counts else None, q if counts else None, masks)
            blocked[rays] |= hit
            pops[rays] += p
            tests[rays] += q
    return (blocked, pops, tests) if counts else blocked


def skip_walk_plain(o, d, chunks, t_far=None, any_hit: bool = False,
                    t_min: float = T_MIN, counts: bool = False, seen: list | None = None):
    """The skip-link kernels' function in plain torch. Closest hit (t_far
    optional): (t, prim), prim -1 and t = min(t_far, T_MAX) on a miss. Any
    hit (t_far required): the blocked flags. With `counts`, also the
    per-ray (node visits, triangle tests). Given a list `seen`, appends
    per chunk a pair of bool masks of the nodes and the triangle slots the
    walk read (the tables' bytes it cannot avoid)."""
    if any_hit:
        return _anyhit_plain(o, d, chunks, t_far, t_min, False, counts, seen)
    return _closest_plain(o, d, chunks, t_far, t_min, False, counts, seen)


def ordered_walk_plain(o, d, chunks, t_far=None, any_hit: bool = False,
                       t_min: float = T_MIN, counts: bool = False, seen: list | None = None):
    """The ordered kernels' function in plain torch; as skip_walk_plain."""
    if any_hit:
        return _anyhit_plain(o, d, chunks, t_far, t_min, True, counts, seen)
    return _closest_plain(o, d, chunks, t_far, t_min, True, counts, seen)


# --------------------------------------------------------------------------
# CUDA kernels.
# --------------------------------------------------------------------------


#: The -D flag of binary_walk.cu's counting build (walk_counts).
COUNTS_DEFINES = ("BINARY_WALK_COUNTS",)


def typed(lib):
    """`lib`, a loaded build of binary_walk.cu (this tree's or another
    checkout's), with its entry points' argument types set."""
    if not getattr(lib, "_blink_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for k in LAUNCHES:
            fn = getattr(lib, k)
            fn.argtypes = [ptr] * 8 + [i32, i32, f32, ptr]
            fn.restype = i32
        for k, args in (("binary_walk_attributes", [i32, i32, ptr]),
                        ("binary_walk_set_counters", [ptr] * 4)):
            if hasattr(lib, k):
                getattr(lib, k).argtypes = args
                getattr(lib, k).restype = i32
        lib._blink_typed = True
    return lib


def _lib(defines: tuple[str, ...] = ()):
    """binary_walk.cu's library built with `defines`, typed."""
    from blink_torch.kernels import _build

    return typed(_build.load("binary_walk", defines))


def kernel_attributes(kind: str, lib=None) -> dict:
    """What the CUDA runtime reports of entry point `kind`'s kernel
    (skip_closest, ...): registers a thread, local memory a thread (the
    ordered walk's stack and any spills), resident blocks an SM, threads a
    block and resident warps an SM. `lib`: another build of
    binary_walk.cu."""
    lib = lib or _lib()
    out = (ctypes.c_int * 4)()
    err = lib.binary_walk_attributes(int(kind.startswith("ordered")),
                                     int(kind.endswith("anyhit")), ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"binary_walk_attributes failed: cudaError {err}")
    return {"registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2],
            "threads": out[3], "warps_per_sm": out[2] * out[3] // 32}


def _launch(kind: str, o, d, c: PackedBVH, out0, out1, t_min: float, lib=None) -> None:
    """One kernel launch over one chunk. Closest: out0 = t (in/out), out1 =
    prim (in/out). Any hit: out0 = t_far, out1 = blocked (in/out). `lib`:
    another build of binary_walk.cu, whose launches LAUNCHES does not
    count."""
    n = o.shape[0]
    dev = o.device
    check_arg("o", o, torch.float32, (n, 3), dev)
    check_arg("d", d, torch.float32, (n, 3), dev)
    if kind.endswith("closest"):
        check_arg("t", out0, torch.float32, (n,), dev)
        check_arg("prim", out1, torch.int32, (n,), dev)
    else:
        check_arg("t_far", out0, torch.float32, (n,), dev)
        check_arg("blocked", out1, torch.bool, (n,), dev)
    nn, p = c.n_nodes, c.tri.shape[0]
    check_arg("box", c.box, torch.float32, (nn, 8), dev)
    check_arg("node", c.node, torch.int32, (nn, 8), dev)
    check_arg("tri", c.tri, torch.float32, (p, 12), dev)
    check_arg("tri_id", c.tri_id, torch.int32, (p,), dev)
    for name, x in (("box", c.box), ("node", c.node), ("tri", c.tri)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (read as float4/int4)")
    if n == 0:
        return
    err = getattr(lib or _lib(), kind)(
        o.data_ptr(), d.data_ptr(), out0.data_ptr(), out1.data_ptr(),
        c.box.data_ptr(), c.node.data_ptr(), c.tri.data_ptr(), c.tri_id.data_ptr(),
        n, nn, t_min, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kind} launch failed: cudaError {err}")
    if lib is None:
        LAUNCHES[kind] += 1


def _is_ordered(variant: str, any_hit: bool) -> bool:
    """Whether `variant` is the ordered walk ("ordered_rg" is an alias of
    "ordered", for closest hit only) rather than the skip-link walk."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant '{variant}'; choices: {VARIANTS}")
    if any_hit and variant == "ordered_rg":
        raise ValueError("ordered_rg is closest-hit only")
    return variant != "skip"


def traverse_closest_packed(o, d, bvh, t_far=None, variant: str = CLOSEST_VARIANT):
    """Closest hit over a PackedBVH or a list of them: (t (N,) f32, prim (N,)
    i32), prim -1 on a miss. `t_far` (optional, per ray) bounds the search;
    t_far = 0 lanes fail every slab test."""
    ordered = _is_ordered(variant, False)
    if not o.is_cuda:
        return _closest_plain(o, d, bvh, t_far, T_MIN, ordered, False)
    return _closest_kernel("ordered_closest" if ordered else "skip_closest", o, d, bvh, t_far)


def _closest_kernel(kind: str, o, d, bvh, t_far, lib=None):
    n = o.shape[0]
    t = torch.full((n,), T_MAX, dtype=torch.float32, device=o.device)
    if t_far is not None:
        t = torch.minimum(t_far.to(torch.float32), t).contiguous()
    prim = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    o, d = o.contiguous(), d.contiguous()
    for c in _as_list(bvh):
        _launch(kind, o, d, c, t, prim, T_MIN, lib)
    return t, prim


def traverse_anyhit_packed(o, d, bvh, t_far, variant: str = "skip"):
    """Any hit over a PackedBVH or a list of them: True where a triangle is
    hit at T_MIN <= t < t_far. Blocked rays skip later chunks."""
    ordered = _is_ordered(variant, True)
    if not o.is_cuda:
        return _anyhit_plain(o, d, bvh, t_far, T_MIN, ordered, False)
    return _anyhit_kernel("ordered_anyhit" if ordered else "skip_anyhit", o, d, bvh, t_far)


def _anyhit_kernel(kind: str, o, d, bvh, t_far, lib=None):
    blocked = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    o, d = o.contiguous(), d.contiguous()
    tf = t_far.to(torch.float32).contiguous()
    for c in _as_list(bvh):
        _launch(kind, o, d, c, tf, blocked, T_MIN, lib)
    return blocked


def walk_counts(kind: str, o, d, bvh, t_far=None):
    """Entry point `kind` (skip_closest, skip_anyhit, ordered_closest,
    ordered_anyhit) through binary_walk.cu's counting build, on CUDA
    tensors: (output, visits, tests, turns, lanes). The output is
    traverse_closest_packed's (t, prim) or traverse_anyhit_packed's blocked
    flags; visits and tests (N,) int64 are each ray's node visits (the
    ordered walk's pops) and triangle tests, summed over the chunks, as
    skip_walk_plain / ordered_walk_plain(..., counts=True) count them;
    turns and lanes (ceil(N / 32),) int64 are each warp's turns (a node step
    or a leaf batch that its lanes run together) and the lanes taking part
    in them, so lanes.sum() / (32 * turns.sum()) is the walk's SIMT
    efficiency."""
    lib = _lib(COUNTS_DEFINES)
    n, dev = o.shape[0], o.device
    visits = torch.zeros(n, dtype=torch.int64, device=dev)
    tests = torch.zeros_like(visits)
    turns = torch.zeros(-(-n // 32), dtype=torch.int64, device=dev)
    lanes = torch.zeros_like(turns)
    err = lib.binary_walk_set_counters(visits.data_ptr(), tests.data_ptr(), turns.data_ptr(),
                                       lanes.data_ptr())
    if err != 0:
        raise RuntimeError(f"binary_walk_set_counters failed: cudaError {err}")
    try:
        out = (_anyhit_kernel(kind, o, d, bvh, t_far, lib) if kind.endswith("anyhit")
               else _closest_kernel(kind, o, d, bvh, t_far, lib))
        torch.cuda.synchronize(dev)
    finally:
        lib.binary_walk_set_counters(None, None, None, None)
    return out, visits, tests, turns, lanes


def skip_walk_counts(o, d, bvh, t_far=None, any_hit: bool = False):
    """walk_counts of the skip-link walk."""
    return walk_counts("skip_anyhit" if any_hit else "skip_closest", o, d, bvh, t_far)
