#!/usr/bin/env python3
"""Time builds of the wide walks (group, row, stream and skip) against each
other on one CUDA card.

    python3 wide_walk_ab.py [--other NAME=DIR ...] [--row-layouts] [--counts]
                            [--rounds R]

Builds src/blink_torch/csrc/wide_walk.cu with the parity flags of
kernels/_build.py as variant `new`, and each `--other NAME=DIR` (another
checkout's root: an earlier commit unpacked with `git archive`, or a
copy with an edited wide_walk.cu) as variant NAME, timed first. Then, on
Sponza 1M, over the 1024x1024 frame's primary rays and their shadow rays,
on the production BVH (group only: it has no row tables) and, with
--row-layouts, on chip_smoke.py's layouts (a) (150k-triangle chunks,
leaves of 44, quantized boxes, row tables) and (b) (build_chunked_wide's
defaults: 120k-triangle chunks, leaves of 32, f32 boxes, row tables)
under the group, row, stream and skip schedules:

  - each variant's closest and any hit, through the launch loops of
    kernels/traverse_wide.py, against the plain torch walk of the same
    schedule, bit for bit (t and prim, the blocked flags);
  - ptxas's spills of the wide kernels, and the runtime's registers,
    local memory and resident warps an SM of every variant's kernel;
  - with --counts, the counting build of the source (-DWIDE_WALK_COUNTS,
    traverse_wide.walk_counts): each ray's node pops and triangle tests in
    the kernel against the plain walk's counts, ray for ray, under every
    schedule timed;
  - the times: R rounds, in each every variant's walks (5 calls each, by
    CUDA events), in forward order in even rounds and in reverse order in
    odd ones; the mean and min over the rounds and each variant's mean
    against the first variant's.

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
from blink_torch.kernels.types import T_MIN  # noqa: E402

BUILD = _build.BUILD_DIR / "ab"
SOURCE = _build.CSRC / "wide_walk.cu"
#: The schedules timed on a layout with row tables.
MODES = tw.LEAF_MODES
log = cs.log


def build(name: str, src: Path, flags: list[str]):
    """(name, loaded library, ptxas's spilled bytes of its wide kernels);
    nvcc's output, ptxas's report with it, beside the library (.log)."""
    BUILD.mkdir(parents=True, exist_ok=True)
    out = BUILD / f"wide_walk-{name}.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o", str(out), str(src)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{' '.join(cmd)}\n{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stdout)
    lib = tw.typed(ctypes.CDLL(str(out)))
    spills = {k: v for k, v in _build.ptxas_spills(proc.stdout).items() if "wide_" in k}
    return name, lib, spills


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="NAME=DIR: the root of another checkout, or of a copy with an edited "
                         "wide_walk.cu")
    ap.add_argument("--row-layouts", action="store_true",
                    help="also layouts (a) and (b), with row tables: group, row, stream, skip")
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
        specs.append(("counts", SOURCE, [f"-D{x}" for x in tw.COUNTS_DEFINES]))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(specs)) as pool:
        built = list(pool.map(lambda s: build(*s), specs))
    counting = built.pop()[1] if args.counts else None
    log(f"[ab] built {len(built)} variants in {time.perf_counter() - t0:.1f} s")
    report, failed = {}, []
    for name, lib, spills in built:
        attrs = {}
        if hasattr(lib, "wide_walk_attributes"):
            attrs = {f"{'any' if a else 'closest'}_{mo}_{'quant' if q else 'f32'}":
                     tw.kernel_attributes(a, mo, q, lib)
                     for mo in MODES for q in (True, False) for a in (False, True)}
        report[name] = {"spill_bytes": spills, "runtime": attrs}
        log(f"[ab] {name}: ptxas spills {json.dumps(spills)}")
        for k, a in attrs.items():
            log(f"[ab] {name} {k} (runtime): {a}")
        if any(spills.values()):
            log(f"[ab] {name}: a wide kernel SPILLS")

    cfg = get_config("sponza").override(width=cs.WIDTH, height=cs.HEIGHT, spp=1,
                                        integrator="direct")
    scene = build_scene(cfg).to(dev)
    layouts = {"production": (kapi.make_backend(cfg.backend, scene).chunks, ("group",))}
    cam = scene.camera.origin.detach().cpu().numpy().astype(np.float32)
    for lay in ("a", "b") if args.row_layouts else ():
        host = tw.build_chunked_wide(scene.triangles, **cs.LEAFMODE_LAYOUTS[lay][1](cam))
        layouts[lay] = ([tw.WideChunk.from_host(c, dev) for c in host], MODES)
    o, d = cs.primary_rays(scene, cs.WIDTH, dev)
    t_prod, p_prod = tw.closest_wide_plain(o, d, layouts["production"][0])
    so, sd, stf = cs.short_shadow_rays(o, d, t_prod, p_prod, scene)
    n = o.shape[0]

    for lay, (chunks, modes) in layouts.items():
        walks = {}  # (walk, mode): (fn(lib), the plain walk's output and counts)
        for mo in modes:
            walks[("closest", mo)] = (
                lambda lib, mo=mo: tw._closest_kernel(mo, o, d, chunks, None, T_MIN, lib),
                tw.closest_wide_plain(o, d, chunks, counts=True, leaf_mode=mo))
            walks[("any", mo)] = (
                lambda lib, mo=mo: tw._anyhit_kernel(mo, so, sd, chunks, stf, T_MIN, lib),
                tw.anyhit_wide_plain(so, sd, chunks, stf, counts=True, leaf_mode=mo))
        if counting is not None:
            for (w, mo), (_, plain) in walks.items():
                rays = (o, d, None) if w == "closest" else (so, sd, stf)
                out, *got = tw.walk_counts(w == "any", *rays[:2], chunks, rays[2],
                                           leaf_mode=mo, lib=counting)
                want = plain[-2:]
                same = all(torch.equal(g, x) for g, x in zip(got, want))
                log(f"[ab] ({lay}) {w} {mo}: the counting build's pops and tests a ray "
                    f"{'equal' if same else 'DIFFER from'} the plain walk's, ray for ray "
                    f"(means {got[0].double().mean().item():.3f} and "
                    f"{got[1].double().mean().item():.3f})")
                report.setdefault("counts", {})[f"{w}_{mo}_{lay}"] = same
                if not same:
                    failed.append(f"counts {w} {mo} ({lay})")
        good = []
        for name, lib, _ in built:
            same = True
            for (w, mo), (fn, plain) in walks.items():
                out = fn(lib)
                if w == "closest":
                    ok = torch.equal(out[0], plain[0]) and torch.equal(out[1], plain[1])
                else:
                    ok = torch.equal(out, plain[0])
                if not ok:
                    log(f"[ab] ({lay}) {name} {w} {mo} DIFFERS from the plain walk")
                same &= ok
            log(f"[ab] ({lay}) {name}: {'identical to' if same else 'DIFFERS from'} the plain "
                f"walks of {', '.join(modes)} on {n} rays ({len(chunks)} chunks)")
            report[name][f"identical_{lay}"] = same
            if same:
                good.append((name, lib))
            else:
                failed.append(f"{name} ({lay})")
        times = {(name, k): [] for name, _ in good for k in walks}
        for r in range(args.rounds):
            for name, lib in good if r % 2 == 0 else good[::-1]:
                for k, (fn, _) in walks.items():
                    times[(name, k)].append(cs.events_ms(lambda: fn(lib), 5))
        for w, mo in walks:
            base = None
            for name, _ in good:
                ts = times[(name, (w, mo))]
                mean = sum(ts) / len(ts)
                base = base or mean
                log(f"[ab] ({lay}) {w:7s} {mo:6s} {name:12s} mean {mean:.4f} ms, "
                    f"min {min(ts):.4f}, max {max(ts):.4f}; {mean / base:.3f} x {good[0][0]}")
                report[name][f"{w}_{mo}_ms_{lay}"] = mean
                report[name][f"{w}_{mo}_min_ms_{lay}"] = min(ts)
    print(smi)
    print(json.dumps({"ab": [{"name": k, **v} for k, v in report.items()
                             if k != "counts"], "counts": report.get("counts")}))
    if failed:
        print(f"wide_walk_ab: differs from the plain walks: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
