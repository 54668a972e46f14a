#!/usr/bin/env python3
"""Time builds of the binary walks (skip-link and ordered) against each
other on one CUDA card.

    python3 binary_walk_ab.py [--other NAME=DIR ...] [--counts] [--rounds R]

Builds src/blink_torch/csrc/binary_walk.cu with the parity flags of
kernels/_build.py as variant `new`, and each `--other NAME=DIR` (another
checkout's root: the parent commit unpacked with `git archive`, or a copy
with an edited binary_walk.cu, the way to try a design variant) as
variant NAME, timed first. Then, on these recorded inputs:

  - config2: config 2 (the bunny through backend 'bvh', 512x512) through
    render(): sample 0's primary rays (closest) and shadow rays (any hit);
  - bounce1..3: the same with integrator 'path', max_depth 4: sample 0's
    closest-hit and any-hit calls of bounces 1-3;
  - sponza: Sponza 1M in 9 packed chunks, leaf 16: chip_smoke.py's 131,072
    primary and random rays and their shadow rays, a third at t_far 0;
  - shard: chip_smoke.py's [shard] inputs, the 1024x1024 frame's 1,048,576
    primary rays over build_sharded_chunks(tris, 1)'s 9 padded chunks, and
    their shadow rays,

each variant's four entry points (KINDS: the skip-link and the ordered
walk, closest and any hit) are held bit for bit to skip_walk_plain and
ordered_walk_plain; ptxas's registers, spills and stack frame of the four
kernels, and, where the build reports them, the runtime's registers, local
memory and resident warps an SM, are printed; with --counts, the counting
build (-DBINARY_WALK_COUNTS, traverse_packed.walk_counts) is held to the
plain walk's node visits (pops) and triangle tests ray for ray, and each
call's SIMT efficiency (lane steps over warp turns x 32) is printed for
the counting build (a turn is a node step or a leaf batch that lanes run
together) and, modelled from the plain walk's steps, for a nested leaf
loop as the first port of each walk ran (a turn is a node step or one
triangle test, the warp reconverging after each leaf); then R rounds, in
each every variant's calls (5 each, by CUDA events), in forward order in
even rounds and in reverse order in odd ones: the mean, min and max over
the rounds and each mean against the first variant's.

Prints one JSON line, {"ab": [...], ...}, last. Exits non-zero without a
card, when a build fails, and when a variant or the counting build differs
from the plain walk (the times are then still printed, for the variants
that agree).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from blink_torch.api import build_scene, render  # noqa: E402
from blink_torch.config import get_config  # noqa: E402
from blink_torch.dist.scene_shard import build_sharded_chunks  # noqa: E402
from blink_torch.kernels import _build  # noqa: E402
from blink_torch.kernels import api as kapi  # noqa: E402
from blink_torch.kernels import traverse_packed as tp  # noqa: E402
from wide_walk_ab import BUILD  # noqa: E402

SOURCE = _build.CSRC / "binary_walk.cu"
KINDS = ("skip_closest", "skip_anyhit", "ordered_closest", "ordered_anyhit")
log = cs.log


def ptxas_registers(text: str) -> dict[str, int]:
    """Registers a thread of each kernel, from ptxas's -v report, by the
    kernel's mangled name."""
    regs, name = {}, None
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name = m.group(1)
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            regs[name] = int(m.group(1))
            name = None
    return regs


def walk_facts(text: str) -> dict:
    """{kind: {registers, spill_bytes, stack_bytes}} of the four kernels in
    ptxas's report `text` (mangled 9skip_walkILb0E ... 12ordered_walkILb1E;
    the stack frame is the local memory a thread, the ordered walk's stack
    and any spills)."""
    regs, spills = ptxas_registers(text), _build.ptxas_spills(text)
    frames = dict(re.findall(r"Function properties for (\w+)\n\s*(\d+) bytes stack frame",
                             text))
    out = {}
    for k, v in spills.items():
        if m := re.search(r"\d+(skip|ordered)_walkILb([01])E", k):
            kind = f"{m.group(1)}_{('closest', 'anyhit')[int(m.group(2))]}"
            out[kind] = {"registers": regs.get(k), "spill_bytes": v,
                         "stack_bytes": int(frames.get(k, 0))}
    return out


def build(name: str, src: Path):
    """(name, typed library, its kernels' ptxas facts)."""
    BUILD.mkdir(parents=True, exist_ok=True)
    out = BUILD / f"binary_walk-{name}.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out), str(src)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{' '.join(cmd)}\n{proc.stdout}")
    return name, tp.typed(ctypes.CDLL(str(out))), walk_facts(proc.stdout)


def call(kind: str, rays, chunks, lib):
    """One call of entry point `kind` of `lib` on rays (o, d, t_far)."""
    o, d, tf = rays
    if kind.endswith("closest"):
        return tp._closest_kernel(kind, o, d, chunks, tf, lib)
    return tp._anyhit_kernel(kind, o, d, chunks, tf, lib)


def nested_model(o, d, chunks, t_far, any_hit: bool, ordered: bool):
    """(warp turns, lane steps) of a walk whose warps run each leaf as a
    nested loop (the first port of each walk), modelled from the plain
    walk's steps: in each step, every warp with a live lane makes one
    node-step turn and then as many leaf turns (one test each) as its
    busiest lane makes tests; a lane step is a node visit or a triangle
    test."""
    n, dev = o.shape[0], o.device
    warps = -(-n // 32)
    turns = torch.zeros(warps, dtype=torch.int64, device=dev)
    lanes = torch.zeros_like(turns)
    bound = torch.full((n,), tp.T_MAX, dtype=torch.float32, device=dev)
    if t_far is not None:
        bound = torch.minimum(t_far, bound)
    blocked = torch.zeros(n, dtype=torch.bool, device=dev)
    for c in chunks:
        rays = torch.nonzero(~blocked).squeeze(1)

        def trace(act, read):
            w = rays[act] // 32
            most = torch.zeros(warps, dtype=torch.int64, device=dev).scatter_reduce(
                0, w, read, "amax")
            stepped = torch.zeros(warps, dtype=torch.bool, device=dev)
            stepped[w] = True
            turns.add_(stepped.long() * (1 + most))
            lanes.index_add_(0, w, 1 + read)

        bt = bound[rays].clone()
        out = tp._walk_chunk(o[rays], d[rays], c, bt, any_hit, tp.T_MIN, ordered, trace=trace)
        if any_hit:
            blocked[rays] |= out
        else:
            bound[rays] = bt
    return int(turns.sum()), int(lanes.sum())


def by_kind(closest, anyhit) -> dict:
    """{kind: rays} of the four entry points: closest-hit rays (o, d,
    t_far) for both walks' closest hit, any-hit rays for both any hits."""
    return {k: closest if k.endswith("closest") else anyhit for k in KINDS}


def record_inputs(dev, size: int | None = None, subdiv: int | None = None,
                  sponza_tris: int | None = None) -> dict:
    """{input name: (chunks, {kind: (o, d, t_far)})} of the walks' calls, at
    full size unless the arguments cut it (a rehearsal on the CPU)."""
    cfg = get_config("bunny").override(backend="bvh", width=size, height=size,
                                       bunny_subdiv=subdiv)
    scene = build_scene(cfg).to(dev)
    backend = kapi.make_backend(cfg.backend, scene)
    inputs = {}
    with cs.Recorder() as rec:
        render(scene, cfg, device=dev, backend=backend)
    o, d, _, _ = rec.calls["packed_closest"][0]
    so, sd, stf, _, _ = rec.calls["packed_anyhit"][0]
    inputs["config2"] = (backend.chunks, by_kind((o, d, None), (so, sd, stf)))
    with cs.Recorder() as rec:
        render(scene, cfg.override(integrator="path", max_depth=4), device=dev,
               backend=backend)
    for b in (1, 2, 3):
        o, d, _, _ = rec.calls["packed_closest"][b]
        so, sd, stf, _, _ = rec.calls["packed_anyhit"][b]
        # The bvh backend walks a bounce's dead lanes too, as blink's does:
        # its closest-hit call takes no t_far.
        inputs[f"bounce{b}"] = (backend.chunks, by_kind((o, d, None), (so, sd, stf)))
    scfg = get_config("sponza").override(width=cs.WIDTH, height=cs.HEIGHT, spp=1,
                                         integrator="direct", sponza_tris=sponza_tris)
    sponza = build_scene(scfg).to(dev)
    chunks = [c.to(dev) for c in tp.build_chunked_packed(sponza.triangles)]
    o, d = cs.binary_rays(sponza, dev)
    t, prim = tp.skip_walk_plain(o, d, chunks)
    so, sd, tf = cs.short_shadow_rays(o, d, t, prim, sponza)
    tf[::3] = 0.0
    inputs["sponza"] = (chunks, by_kind((o, d, None), (so, sd, tf)))
    chunks = [c.to(dev) for c in build_sharded_chunks(sponza.triangles, 1)[0]]
    o, d = cs.primary_rays(sponza, cs.WIDTH, dev)
    t, prim = tp.traverse_closest_packed(o, d, chunks, variant="skip")
    inputs["shard"] = (chunks, by_kind((o, d, None), cs.short_shadow_rays(o, d, t, prim, sponza)))
    return inputs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="NAME=DIR: the root of another checkout, or of a copy with an edited "
                         "binary_walk.cu")
    ap.add_argument("--counts", action="store_true",
                    help="check the counting build ray for ray; SIMT efficiency")
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("binary_walk_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"[ab] {smi}")

    specs = [(name, Path(root) / "src/blink_torch/csrc/binary_walk.cu")
             for name, _, root in (v.partition("=") for v in args.other)]
    specs.append(("new", SOURCE))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(specs) + 1) as pool:
        counting = pool.submit(tp._lib, tp.COUNTS_DEFINES) if args.counts else None
        built = list(pool.map(lambda s: build(*s), specs))
        if counting is not None:
            counting.result()
    log(f"[ab] built {len(built)} variants{' and the counting build' if args.counts else ''} "
        f"in {time.perf_counter() - t0:.1f} s")
    report, failed = {}, []
    for name, lib, facts in built:
        runtime = {}
        if hasattr(lib, "binary_walk_attributes"):
            runtime = {k: tp.kernel_attributes(k, lib) for k in KINDS}
        report[name] = {"ptxas": facts, "runtime": runtime}
        log(f"[ab] {name}: ptxas {json.dumps(facts)}; runtime {json.dumps(runtime)}")

    t0 = time.perf_counter()
    inputs = record_inputs(dev)
    log(f"[ab] inputs recorded in {time.perf_counter() - t0:.1f} s: " + ", ".join(
        f"{k} {v[1]['skip_closest'][0].shape[0]} rays over {len(v[0])} chunks"
        for k, v in inputs.items()))
    good = [(name, lib) for name, lib, _ in built]
    for inp, (chunks, rays) in inputs.items():
        for kind, r in rays.items():
            any_hit = kind.endswith("anyhit")
            t0 = time.perf_counter()
            walk = tp.ordered_walk_plain if kind.startswith("ordered") else tp.skip_walk_plain
            ref = walk(r[0], r[1], chunks, t_far=r[2], any_hit=any_hit, counts=True)
            out_ref = ref[0] if any_hit else ref[:2]
            for name, lib in list(good):
                out = call(kind, r, chunks, lib)
                same = (torch.equal(out, out_ref) if any_hit else
                        torch.equal(out[0], out_ref[0]) and torch.equal(out[1], out_ref[1]))
                report[name][f"identical_{inp}_{kind}"] = same
                if not same:
                    log(f"[ab] {name} DIFFERS from the plain walk on {inp} {kind}")
                    failed.append(f"{name} {inp} {kind}")
                    good.remove((name, lib))
            log(f"[ab] {inp} {kind}: checked in {time.perf_counter() - t0:.1f} s")
            if not args.counts:
                continue
            out, visits, tests, turns, lanes = tp.walk_counts(kind, r[0], r[1], chunks, r[2])
            same = torch.equal(visits, ref[-2]) and torch.equal(tests, ref[-1])
            n = r[0].shape[0]
            m_turns, m_lanes = nested_model(r[0], r[1], chunks, r[2], any_hit,
                                            kind.startswith("ordered"))
            c = {"same": same, "visits": visits.double().mean().item(),
                 "tests": tests.double().mean().item(), "turns": int(turns.sum()),
                 "simt": int(lanes.sum()) / (32 * int(turns.sum())),
                 "nested_turns": m_turns, "nested_simt": m_lanes / (32 * m_turns)}
            report.setdefault("counts", {})[f"{inp}_{kind}"] = c
            log(f"[ab] counts {inp} {kind}: {n} rays, visits and tests a ray "
                f"{'equal' if same else 'DIFFER from'} the plain walk's ray for ray "
                f"({c['visits']:.3f}, {c['tests']:.3f}); warp turns {c['turns']} "
                f"(SIMT efficiency {c['simt']:.4f}); a nested leaf loop, modelled: "
                f"{m_turns} turns (SIMT efficiency {c['nested_simt']:.4f})")
            if not same:
                failed.append(f"counts {inp} {kind}")

    calls = [(inp, kind) for inp, (_, rays) in inputs.items() for kind in rays]
    times = {(name, c): [] for name, _ in good for c in calls}
    for rnd in range(args.rounds):
        for name, lib in good if rnd % 2 == 0 else good[::-1]:
            for inp, kind in calls:
                chunks, rays = inputs[inp]
                times[(name, (inp, kind))].append(
                    cs.events_ms(lambda: call(kind, rays[kind], chunks, lib), 5))
    for inp, kind in calls:
        base = None
        for name, _ in good:
            ts = times[(name, (inp, kind))]
            mean = sum(ts) / len(ts)
            base = base or mean
            log(f"[ab] {inp:8s} {kind:15s} {name:14s} mean {mean:.4f} ms, min {min(ts):.4f}, "
                f"max {max(ts):.4f}; {mean / base:.3f} x {good[0][0]}")
            report[name][f"{inp}_{kind}_ms"] = mean
            report[name][f"{inp}_{kind}_min_ms"] = min(ts)
            report[name][f"{inp}_{kind}_max_ms"] = max(ts)
    print(smi)
    print(json.dumps({"ab": [{"name": k, **v} for k, v in report.items() if k != "counts"],
                      "counts": report.get("counts")}))
    if failed:
        print(f"binary_walk_ab: differs from the plain walk: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
