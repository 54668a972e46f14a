#!/usr/bin/env python3
"""Time builds of the sphere pass against each other on one CUDA card.

    python3 sphere_pass_ab.py [--other NAME=DIR ...] [--rounds R]

Builds src/blink_torch/csrc/sphere_pass.cu with the parity flags of
kernels/_build.py as variant `new`, and each `--other NAME=DIR` (another
checkout's root: an earlier commit unpacked with `git archive`, or a copy
with an edited sphere_pass.cu) as variant NAME, timed first; and this
tree's source with -DSPHERE_PASS_EMPTY as `empty`, the same grid with no
work. Then, on config 3 (Cornell 256x256 through backend 'pallas', one
render recorded) and on phase 2's rays of chip_smoke.py repeated to
1,048,576 with the scene's 8 spheres:

  - each build's kernel against the plain version bit for bit (the pass,
    and, where the build has it, the pass merged into a closest hit);
  - what kernels/api.py does with each build, per case: `closest` the
    recorded closest hit's sphere step (a build without the merged entry:
    the pass, then the caller's compare and three selects; with it, one
    launch), `pass` the same step unmerged, `occlusion` the recorded
    occlusion test's (the pass, then a compare and an or), and `big` the
    pass at 1,048,576 rays; a build that takes an (S, 4) table (the
    parent's) gets it from torch.cat in every call, as its wrapper did;
  - the times: R rounds, in each every build's cases in forward order in
    even rounds and in reverse in odd ones, each case as the device time
    a call of all its kernels and of the sphere kernel alone
    (torch.profiler, 50 calls) and as the time a call by CUDA events (100
    calls, the host's launches included); means and min over the rounds,
    and each build's means against the first build's;
  - ptxas's registers and the runtime's registers and resident warps an
    SM of each build's kernels.

Prints one JSON line, {"ab": [...]}, last. Exits non-zero without a card,
when a build fails, and when a build differs from the plain version.
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

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from blink_torch.api import build_scene, render  # noqa: E402
from blink_torch.config import get_config  # noqa: E402
from blink_torch.kernels import _build  # noqa: E402
from blink_torch.kernels import api as kapi  # noqa: E402
from blink_torch.kernels import sphere as ks  # noqa: E402
from blink_torch.kernels.types import T_MIN  # noqa: E402

BUILD = _build.BUILD_DIR / "ab"
SOURCE = _build.CSRC / "sphere_pass.cu"
KERNEL = "sphere_pass_kernel"
log = cs.log


def build(name: str, src: Path, flags: list[str]):
    """(name, loaded library, ptxas's report lines); nvcc's output beside
    the library (.log). A build with sphere_merge_launch is typed as this
    tree's; an earlier one (sphere_pass over an (S, 4) table) by hand."""
    BUILD.mkdir(parents=True, exist_ok=True)
    out = BUILD / f"sphere_pass-{name}.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o", str(out), str(src)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{' '.join(cmd)}\n{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stdout)
    lib = ctypes.CDLL(str(out))
    if hasattr(lib, "sphere_merge_launch"):
        ks.typed(lib)
    else:
        ptr = ctypes.c_void_p
        lib.sphere_pass.argtypes = [ptr] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ptr]
        lib.sphere_pass.restype = ctypes.c_int
    report = [ln.strip() for ln in proc.stdout.splitlines() if "registers" in ln or "spill" in ln]
    return name, lib, report


def table_pass(lib, o, d, center, radius, t_min, t_max):
    """An earlier build's pass as its wrapper ran it: the (S, 4) table by
    torch.cat, then one launch."""
    n, s = o.shape[0], center.shape[0]
    tab = torch.cat([center, radius[:, None]], dim=1).to(torch.float32).contiguous()
    t = torch.empty((n,), dtype=torch.float32, device=o.device)
    prim = torch.empty((n,), dtype=torch.int32, device=o.device)
    err = lib.sphere_pass(o.data_ptr(), d.data_ptr(), t_max.data_ptr(), tab.data_ptr(),
                          t.data_ptr(), prim.data_ptr(), n, s, t_min,
                          torch.cuda.current_stream(o.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sphere_pass launch failed: cudaError {err}")
    return t, prim


def pass_of(lib):
    """The build's pass as its wrapper runs it: fn(o, d, center, radius,
    t_min, t_max) -> (t, prim)."""
    if hasattr(lib, "sphere_merge_launch"):
        return lambda *a: ks._kernel(*a, lib=lib)
    return lambda *a: table_pass(lib, *a)


def cases_of(lib, rec, big) -> dict:
    """What kernels/api.py runs with `lib`, per case: {case: fn()}."""
    o, d, c, r, t_min, (t, kind, prim), _ = rec["sphere_merge"][0]
    so, sd, sc, sr, s_tmin, tf, _ = rec["sphere_pass"][0]
    blocked = torch.zeros(so.shape[0], dtype=torch.bool, device=so.device)
    pas = pass_of(lib)

    def unmerged():
        return ks.merge_hit(*pas(o, d, c, r, t_min, t), t, kind, prim)

    def merged():
        return ks._kernel(o, d, c, r, t_min, t, merge=(kind, prim), lib=lib)

    return {
        "closest": merged if hasattr(lib, "sphere_merge_launch") else unmerged,
        "pass": unmerged,
        "occlusion": lambda: blocked | (pas(so, sd, sc, sr, s_tmin, tf)[0] < tf),
        "big": lambda: pas(*big),
    }


def identical(lib, rec, big) -> bool:
    """The build's pass (and merged entry) against the plain versions, bit
    for bit, on every recorded call and on the big case."""
    pas = pass_of(lib)
    same = True
    for o, d, c, r, t_min, t_in, _ in rec["sphere_pass"]:
        same &= all(torch.equal(x, y) for x, y in zip(
            pas(o, d, c, r, t_min, t_in), ks.sphere_pass_plain(o, d, c, r, t_min, t_in)))
    same &= all(torch.equal(x, y) for x, y in zip(pas(*big), ks.sphere_pass_plain(*big)))
    if hasattr(lib, "sphere_merge_launch"):
        for o, d, c, r, t_min, (t, kind, prim), _ in rec["sphere_merge"]:
            got = ks._kernel(o, d, c, r, t_min, t, merge=(kind, prim), lib=lib)
            want = ks.sphere_merge_plain(o, d, c, r, t_min, t, kind, prim)
            same &= all(torch.equal(x, y) for x, y in zip(got, want))
    return same


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="NAME=DIR: the root of another checkout, or of a copy with an edited "
                         "sphere_pass.cu")
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sphere_pass_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"[ab] {smi}")

    specs = [(name, Path(root) / "src/blink_torch/csrc/sphere_pass.cu", [])
             for name, _, root in (v.partition("=") for v in args.other)]
    specs += [("new", SOURCE, []), ("empty", SOURCE, [f"-D{x}" for x in ks.EMPTY_DEFINES])]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(specs)) as pool:
        built = list(pool.map(lambda s: build(*s), specs))
    log(f"[ab] built {len(built)} variants in {time.perf_counter() - t0:.1f} s")
    report, failed = {}, []
    for name, lib, lines in built:
        attrs = ({k: ks.kernel_attributes(m, lib) for k, m in (("pass", False), ("merge", True))}
                 if hasattr(lib, "sphere_pass_attributes") else {})
        report[name] = {"ptxas": lines, "runtime": attrs}
        log(f"[ab] {name}: ptxas {lines}; runtime {attrs}")

    cfg = get_config("fit").override(backend="pallas")
    scene = build_scene(cfg).to(dev)
    backend = kapi.make_backend(cfg.backend, scene)
    with cs.Recorder() as r:
        render(scene, cfg, device=dev, backend=backend)
        torch.cuda.synchronize()
    rec = {k: r.calls[k] for k in ("sphere_pass", "sphere_merge")}
    _, (bo, bd, bcaps, bc, br) = cs.phase_sphere_parity(dev)
    big = (bo, bd, bc, br, T_MIN, bcaps)
    log(f"[ab] config 3 {cfg.width}x{cfg.height}: {len(rec['sphere_merge'])} closest-hit and "
        f"{len(rec['sphere_pass'])} occlusion calls of {rec['sphere_pass'][0][0].shape[0]} rays, "
        f"{scene.n_spheres} spheres; big: {bo.shape[0]} rays")

    good = []
    for name, lib, _ in built:
        if name == "empty":
            good.append((name, lib))
            continue
        same = identical(lib, rec, big)
        log(f"[ab] {name}: {'identical to' if same else 'DIFFERS from'} the plain versions")
        report[name]["identical"] = same
        if same:
            good.append((name, lib))
        else:
            failed.append(name)
    fns = {name: cases_of(lib, rec, big) for name, lib in good}
    times = {(name, k, m): [] for name in fns for k in fns[name] for m in ("device", "kernel",
                                                                          "events")}
    for rnd in range(args.rounds):
        for name in list(fns) if rnd % 2 == 0 else list(fns)[::-1]:
            for k, fn in fns[name].items():
                times[(name, k, "device")].append(cs.device_time(fn, 50)[0])
                times[(name, k, "kernel")].append(cs.device_time(fn, 50, KERNEL)[0])
                times[(name, k, "events")].append(cs.events_ms(fn, 100))
    base = {}
    for k in fns[good[0][0]]:
        for m in ("device", "kernel", "events"):
            for name in fns:
                ts = times[(name, k, m)]
                mean = sum(ts) / len(ts)
                base.setdefault((k, m), mean)
                log(f"[ab] {k:9s} {m:6s} {name:10s} mean {mean:.6f} ms, min {min(ts):.6f}, "
                    f"max {max(ts):.6f}; {mean / base[(k, m)]:.3f} x {good[0][0]}")
                report[name][f"{k}_{m}_ms"] = mean
                report[name][f"{k}_{m}_min_ms"] = min(ts)
    print(smi)
    print(json.dumps({"ab": [{"name": k, **v} for k, v in report.items()]}))
    if failed:
        print(f"sphere_pass_ab: differs from the plain version: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
