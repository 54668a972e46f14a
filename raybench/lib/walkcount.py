"""The wide walk's work, counted again from the rays and the BVH that were
walked, and its roofline bound.

`count` is a frozen copy of the plain wide walk's counting arithmetic
(group leaf schedule): for each ray, the 8-wide node pops and triangle
tests of the closest-hit or any-hit walk over the program's chunks,
threading the best t (or the blocked flags) from chunk to chunk. It reads
the chunk tables by their field names (child, nbox, perm, tri, tri_id,
max_stack); a backend without them is not a wide backend, and nothing is
counted.

Model (the walk on one H100 SXM at its 700 W data-sheet rates): 20 FP32
operations a slab test, 8 of them a pop (160), and 35 a Möller–Trumbore
test, over 67 TFLOP/s; 32 bytes of ray I/O a live ray (o and d read, t and
prim written), over 3.35 TB/s. The bound is the larger of the two.
"""
from __future__ import annotations

import torch

FP32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12
POP_OPS = 8 * 20
TEST_OPS = 35
RAY_BYTES = 32
T_MAX = 1e30
T_MIN = 1e-3
#: Every SAMPLE-th live ray of a call is counted.
SAMPLE = 16


def _triangle_t(o, d, v0, e1, e2, t_min, t_max):
    pvec = torch.stack([d[..., 1] * e2[..., 2] - d[..., 2] * e2[..., 1],
                        d[..., 2] * e2[..., 0] - d[..., 0] * e2[..., 2],
                        d[..., 0] * e2[..., 1] - d[..., 1] * e2[..., 0]], -1)

    def dot(a, b):
        return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]

    det = dot(e1, pvec)
    degenerate = det == 0.0
    inv_det = 1.0 / torch.where(degenerate, torch.ones_like(det), det)
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = torch.stack([tvec[..., 1] * e1[..., 2] - tvec[..., 2] * e1[..., 1],
                        tvec[..., 2] * e1[..., 0] - tvec[..., 0] * e1[..., 2],
                        tvec[..., 0] * e1[..., 1] - tvec[..., 1] * e1[..., 0]], -1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    valid = (~degenerate & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= t_min)
             & (t <= t_max))
    return torch.where(valid, t, torch.full_like(t, T_MAX))


def _slab(o, ix, t_min, t_max, lo, hi):
    t0 = (lo - o) * ix
    t1 = (hi - o) * ix
    tn = torch.minimum(t0, t1)
    tf = torch.maximum(t0, t1)
    near = torch.maximum(torch.maximum(tn[..., 0], tn[..., 1]), tn[..., 2])
    far = torch.minimum(torch.minimum(tf[..., 0], tf[..., 1]), tf[..., 2])
    near = torch.where(torch.isnan(near), -torch.inf, near)
    far = torch.where(torch.isnan(far), torch.inf, far)
    return torch.clamp(near, min=t_min) <= torch.minimum(far, t_max)


def _leaf_tests(oa, da, bta, r, base, cnt, chunk, any_hit: bool, ntest):
    M = bta.shape[0]
    dev = bta.device
    first = torch.cumsum(cnt, 0) - cnt
    pair = torch.repeat_interleave(torch.arange(r.numel(), device=dev), cnt)
    E = pair.numel()
    pos = torch.arange(E, device=dev)
    rr = r[pair]
    row = base[pair] + (pos - first[pair])
    rec = chunk.tri[row]
    t = _triangle_t(oa[rr], da[rr], rec[:, 0:3], rec[:, 3:6], rec[:, 6:9], T_MIN, bta[rr])
    hit = t < bta[rr]
    big = torch.full((M,), E, dtype=torch.int64, device=dev)
    win = big.scatter_reduce(0, rr, torch.where(hit, pos, E), "amin")
    got = win < E
    if any_hit:
        start = big.scatter_reduce(0, rr, pos, "amin")
        total = torch.zeros(M, dtype=torch.int64, device=dev).index_add_(0, r, cnt)
        ntest += torch.where(got, win - start + 1, total)
        return got, None
    ntest.index_add_(0, r, cnt)
    tmin = torch.full((M,), torch.inf, device=dev).scatter_reduce(
        0, rr, torch.where(hit, t, torch.inf), "amin")
    return got, tmin


def _walk(o, d, chunk, bt, any_hit: bool, pops, tests):
    """One chunk's group walk for rays (B,) with best t / bound `bt`
    (lowered in place for a closest hit): counts into pops and tests;
    returns the blocked flags (any hit)."""
    B = o.shape[0]
    dev = o.device
    ix = 1.0 / d
    octant = (d[:, 0] >= 0).long() + 2 * (d[:, 1] >= 0).long() + 4 * (d[:, 2] >= 0).long()
    quant = chunk.child.dtype == torch.int32
    child = chunk.child.view(-1, 3 if quant else 8)
    stack = torch.zeros((B, chunk.max_stack), dtype=torch.int64, device=dev)
    sp = torch.ones(B, dtype=torch.int64, device=dev)
    blocked = torch.zeros(B, dtype=torch.bool, device=dev)
    shifts = 3 * torch.arange(8, device=dev)
    while True:
        act = torch.nonzero(sp > 0).squeeze(1)
        M = act.numel()
        if M == 0:
            break
        spa = sp[act] - 1
        node = stack[act, spa]
        pops[act] += 1
        pm = chunk.perm[node * 8 + octant[act]].long()
        c8 = (pm[:, None] >> shifts) & 7
        rec = child[node[:, None] * 8 + c8]
        if quant:
            rec = rec.long()
            w0, w1, ref = rec[..., 0], rec[..., 1], rec[..., 2]
            cnt = w0 >> 24
            q_lo = torch.stack([w0 & 255, (w0 >> 8) & 255, (w0 >> 16) & 255], -1)
            q_hi = torch.stack([w1 & 255, (w1 >> 8) & 255, (w1 >> 16) & 255], -1)
            nb = chunk.nbox.view(-1, 8)[node]
            org, stp = nb[:, None, 0:3], nb[:, None, 3:6]
            lo = org + q_lo.float() * stp
            hi = org + q_hi.float() * stp
        else:
            lo, hi = rec[..., 0:3], rec[..., 3:6]
            ref, cnt = rec[..., 6].long(), rec[..., 7].long()
        need = _slab(o[act][:, None], ix[act][:, None], T_MIN, bt[act][:, None], lo, hi)
        done = torch.zeros(M, dtype=torch.bool, device=dev)
        li, lk = torch.nonzero(need & (cnt > 0), as_tuple=True)
        if li.numel():
            ntest = torch.zeros(M, dtype=torch.int64, device=dev)
            got, tnew = _leaf_tests(o[act], d[act], bt[act], li, ref[li, lk], cnt[li, lk],
                                    chunk, any_hit, ntest)
            tests[act] += ntest
            if any_hit:
                blocked[act[got]] = True
                done = got
            else:
                w = torch.nonzero(got).squeeze(1)
                bt[act[w]] = tnew[w]
        push = need & (cnt == 0) & (ref > 0) & ~done[:, None]
        above = push.flip(1).long().cumsum(1).flip(1) - push.long()
        pi, pk = torch.nonzero(push, as_tuple=True)
        stack[act[pi], spa[pi] + above[pi, pk]] = ref[pi, pk]
        sp[act] = torch.where(done, 0, spa + push.sum(1))
    return blocked


_BATCH = 1 << 16


def count(o, d, t_far, chunks, any_hit: bool):
    """(pops, tests) summed over rays (N,) walked from o along d up to
    t_far over `chunks`, as the program's wide walk does them."""
    n = o.shape[0]
    pops = torch.zeros(n, dtype=torch.int64, device=o.device)
    tests = torch.zeros_like(pops)
    bound = torch.clamp(t_far.float(), max=T_MAX)
    blocked = torch.zeros(n, dtype=torch.bool, device=o.device)
    for c in chunks:
        rays = torch.nonzero(~blocked).squeeze(1) if any_hit else torch.arange(n, device=o.device)
        for s in range(0, rays.numel(), _BATCH):
            r = rays[s:s + _BATCH]
            p = torch.zeros(r.numel(), dtype=torch.int64, device=o.device)
            q = torch.zeros_like(p)
            bt = bound[r].clone()
            hit = _walk(o[r], d[r], c, bt, any_hit, p, q)
            if any_hit:
                blocked[r] |= hit
            else:
                bound[r] = bt
            pops[r] += p
            tests[r] += q
    return int(pops.sum()), int(tests.sum())


class Recorder:
    """Wraps a backend class's `intersect` and `occluded` while open, and
    keeps every SAMPLE-th live ray of each call with the call's number of
    live rays (a closest hit's `alive` lanes; an any hit's t_far > 0)."""

    def __init__(self, backend_cls):
        self.cls = backend_cls
        self.calls = []  # (any_hit, o, d, t_far, n_live, chunks)

    def _keep(self, any_hit, backend, o, d, t_far, live):
        idx = torch.nonzero(live).squeeze(1)
        sub = idx[::SAMPLE]
        self.calls.append((any_hit, o.detach()[sub].float(), d.detach()[sub].float(),
                           t_far[sub].float(), int(idx.numel()), backend.chunks))

    def __enter__(self):
        inter, occ = self.cls.intersect, self.cls.occluded
        rec = self

        def intersect(be, o, d, scene, alive=None):
            live = (torch.ones(o.shape[0], dtype=torch.bool, device=o.device) if alive is None
                    else alive)
            rec._keep(False, be, o, d, torch.where(live, T_MAX, 0.0), live)
            return inter(be, o, d, scene, alive)

        def occluded(be, o, d, scene, t_far):
            tf = t_far.detach().float()
            rec._keep(True, be, o, d, tf, tf > 0)
            return occ(be, o, d, scene, t_far)

        self._orig = (inter, occ)
        self.cls.intersect, self.cls.occluded = intersect, occluded
        return self

    def __exit__(self, *exc):
        self.cls.intersect, self.cls.occluded = self._orig
        return False


def walk_work(calls) -> dict | None:
    """Pops, tests and live rays over the recorded calls, the sampled
    counts scaled to each call's live rays; None where a backend has no
    wide chunks."""
    pops = tests = live = 0.0
    for any_hit, o, d, t_far, n_live, chunks in calls:
        if not chunks or not hasattr(chunks[0], "perm"):
            return None
        if o.shape[0] == 0:
            continue
        p, q = count(o, d, t_far, chunks, any_hit)
        scale = n_live / o.shape[0]
        pops += p * scale
        tests += q * scale
        live += n_live
    return {"pops": pops, "tests": tests, "live_rays": live, "calls": len(calls)}


def bound_s(work: dict) -> tuple[float, str]:
    """(seconds, 'operations' or 'bytes'): the least time the walks of
    `work` could take on the card."""
    ops = POP_OPS * work["pops"] + TEST_OPS * work["tests"]
    t_ops = ops / FP32_FLOPS
    t_bytes = RAY_BYTES * work["live_rays"] / HBM_BYTES_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
