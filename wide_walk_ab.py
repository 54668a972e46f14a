#!/usr/bin/env python3
"""Time builds of the group wide walk against each other on one CUDA card.

    python3 wide_walk_ab.py [--other NAME=DIR ...] [--layout-a] [--counts]
                            [--rounds R]

Builds src/blink_torch/csrc/wide_walk.cu with the parity flags of
kernels/_build.py as variant `new`, and each `--other NAME=DIR` (another
checkout's root: an earlier commit unpacked with `git archive`, or a
copy with an edited wide_walk.cu) as variant NAME, timed first. Then, on
Sponza 1M with the production BVH (and, with --layout-a, chip_smoke.py's
layout (a)), over the 1024x1024 frame's primary rays and their shadow
rays:

  - each variant's closest and any hit, through the wrappers of
    kernels/traverse_wide.py, against the plain torch walk, bit for bit
    (t and prim, the blocked flags);
  - ptxas's spills of the group kernels, and the runtime's registers,
    local memory and resident warps an SM;
  - with --counts, a counting build of the source (-DWIDE_GROUP_COUNTS):
    each ray's node pops and triangle tests in the kernel against the
    plain walk's counts, ray for ray;
  - the times: R rounds, in each every variant's closest and any hit
    (5 calls each, by CUDA events), in forward order in even rounds and
    in reverse order in odd ones; the mean and min over the rounds and
    each variant's mean against the first variant's.

Prints one JSON line, {"ab": [...]}, last. Exits non-zero without a card,
when a build fails, and when a variant or the counting build differs from
the plain walks (the times are then still printed, for the variants that
agree).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from blink_torch.api import build_scene  # noqa: E402
from blink_torch.config import get_config  # noqa: E402
from blink_torch.kernels import _build  # noqa: E402
from blink_torch.kernels import api as kapi  # noqa: E402
from blink_torch.kernels import traverse_wide as tw  # noqa: E402

BUILD = _build.BUILD_DIR / "ab"
SOURCE = _build.CSRC / "wide_walk.cu"
log = cs.log


def build(name: str, src: Path, flags: list[str]):
    """(name, loaded library, ptxas's spilled bytes of its group kernels)."""
    BUILD.mkdir(parents=True, exist_ok=True)
    out = BUILD / f"wide_walk-{name}.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o", str(out), str(src)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{' '.join(cmd)}\n{proc.stdout}")
    lib = ctypes.CDLL(str(out))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.wide_walk_launch.argtypes = [i32] * 3 + [ptr] * 12 + [i32, f32, ptr]
    lib.wide_walk_launch.restype = i32
    if hasattr(lib, "wide_walk_attributes"):
        lib.wide_walk_attributes.argtypes = [i32, i32, i32, ptr]
        lib.wide_walk_attributes.restype = i32
    lib._blink_typed = True
    spills = {k: v for k, v in _build.ptxas_spills(proc.stdout).items() if "wide_group_walk" in k}
    return name, lib, spills


def with_lib(lib, fn):
    """fn() with the wrappers of traverse_wide launching `lib`."""
    saved = tw._lib
    tw._lib = lambda: lib
    try:
        return fn()
    finally:
        tw._lib = saved


def counted(lib, fn, n: int, dev):
    """(pops, tests) per ray of fn() run through the counting build `lib`."""
    pops = torch.zeros(n, dtype=torch.int64, device=dev)
    tests = torch.zeros_like(pops)
    if lib.wide_walk_set_counters(pops.data_ptr(), tests.data_ptr()) != 0:
        raise RuntimeError("wide_walk_set_counters failed")
    try:
        with_lib(lib, fn)
        torch.cuda.synchronize()
    finally:
        lib.wide_walk_set_counters(None, None)
    return pops, tests


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="NAME=DIR: the root of another checkout, or of a copy with an edited "
                         "wide_walk.cu")
    ap.add_argument("--layout-a", action="store_true")
    ap.add_argument("--counts", action="store_true",
                    help="check each ray's pops and tests with a counting build")
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wide_walk_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"[ab] {smi}")

    specs = []
    for v in args.other:
        name, _, root = v.partition("=")
        specs.append((name, Path(root) / "src/blink_torch/csrc/wide_walk.cu", []))
    specs.append(("new", SOURCE, []))
    if args.counts:
        specs.append(("counts", SOURCE, ["-DWIDE_GROUP_COUNTS"]))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(specs)) as pool:
        built = list(pool.map(lambda s: build(*s), specs))
    counting = None
    if args.counts:
        counting = built.pop()[1]
        counting.wide_walk_set_counters.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        counting.wide_walk_set_counters.restype = ctypes.c_int
    log(f"[ab] built {len(built)} variants in {time.perf_counter() - t0:.1f} s")
    report, failed = {}, []
    for name, lib, spills in built:
        attrs = {}
        if hasattr(lib, "wide_walk_attributes"):
            attrs = {("any" if a else "closest"): tw.kernel_attributes(a, "group", True, lib)
                     for a in (False, True)}
        report[name] = {"spill_bytes": spills, "runtime": attrs}
        for k, v in spills.items():
            log(f"[ab] {name}: {k} spills {v} bytes")
        for k, a in attrs.items():
            log(f"[ab] {name} {k} (runtime): {a}")

    cfg = get_config("sponza").override(width=cs.WIDTH, height=cs.HEIGHT, spp=1,
                                        integrator="direct")
    scene = build_scene(cfg).to(dev)
    layouts = {"production": kapi.make_backend(cfg.backend, scene).chunks}
    if args.layout_a:
        cam = scene.camera.origin.detach().cpu().numpy().astype(np.float32)
        host = tw.build_chunked_wide(scene.triangles, **cs.LEAFMODE_LAYOUTS["a"][1](cam))
        layouts["a"] = [tw.WideChunk.from_host(c, dev) for c in host]
    o, d = cs.primary_rays(scene, cs.WIDTH, dev)
    t_prod, p_prod = tw.closest_wide_plain(o, d, layouts["production"])
    so, sd, stf = cs.short_shadow_rays(o, d, t_prod, p_prod, scene)
    n = o.shape[0]

    for lay, chunks in layouts.items():
        t_c, p_c, *counts_c = tw.closest_wide_plain(o, d, chunks, counts=True)
        ref_c = (t_c, p_c)
        ref_a, *counts_a = tw.anyhit_wide_plain(so, sd, chunks, stf, counts=True)
        walks = {
            "closest": lambda: tw.traverse_closest_wide(o, d, chunks),
            "any": lambda: tw.traverse_anyhit_wide(so, sd, chunks, stf),
        }
        if counting is not None:
            for w, want in (("closest", counts_c), ("any", counts_a)):
                got = counted(counting, walks[w], n, dev)
                same = all(torch.equal(g, x) for g, x in zip(got, want))
                log(f"[ab] ({lay}) {w}: the counting build's pops and tests a ray "
                    f"{'equal' if same else 'DIFFER from'} the plain walk's, ray for ray "
                    f"(means {got[0].double().mean().item():.3f} and "
                    f"{got[1].double().mean().item():.3f})")
                report.setdefault("counts", {})[f"{w}_{lay}"] = same
                if not same:
                    failed.append(f"counts {w} ({lay})")
        good = []
        for name, lib, _ in built:
            t, prim = with_lib(lib, walks["closest"])
            blocked = with_lib(lib, walks["any"])
            same = (torch.equal(t, ref_c[0]) and torch.equal(prim, ref_c[1])
                    and torch.equal(blocked, ref_a))
            log(f"[ab] ({lay}) {name}: {'identical to' if same else 'DIFFERS from'} the plain "
                f"walks on {n} rays ({len(chunks)} chunks)")
            report[name][f"identical_{lay}"] = same
            if same:
                good.append((name, lib))
            else:
                failed.append(f"{name} ({lay})")
        times = {(name, w): [] for name, _ in good for w in walks}
        for r in range(args.rounds):
            for name, lib in good if r % 2 == 0 else good[::-1]:
                for w, fn in walks.items():
                    times[(name, w)].append(with_lib(lib, lambda: cs.events_ms(fn, 5)))
        for w in walks:
            base = None
            for name, _ in good:
                ts = times[(name, w)]
                mean = sum(ts) / len(ts)
                base = base or mean
                log(f"[ab] ({lay}) {w:7s} {name:12s} mean {mean:.4f} ms, min {min(ts):.4f}, "
                    f"max {max(ts):.4f}; {mean / base:.3f} x {good[0][0]}")
                report[name][f"{w}_ms_{lay}"] = mean
                report[name][f"{w}_min_ms_{lay}"] = min(ts)
    print(smi)
    print(json.dumps({"ab": [{"name": k, **v} for k, v in report.items()
                             if k != "counts"], "counts": report.get("counts")}))
    if failed:
        print(f"wide_walk_ab: differs from the plain walks: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
