"""One run of one cell: set-up, warm-up, the measured window, the traced
stretch, the check against the reference, and the result line.

Everything a cell is made of is found by name from `BENCHMARK.json`: its
configuration file (`configs[].file`), the scene that file names
(`raybench/scenes/<scene>.py`: `build(**scene_args)` and `TINY_ARGS`),
the reference it names (`raybench/reference/<reference>.py`, `render` by
default), its traffic mix (`raybench/traffic/<traffic>.json`), the limits
of its comparison (`raybench/limits/<workload>.json`) and each metric's
reader (`raybench/metrics/<metric>.py`, a function `read(ctx)` that
returns a number or None). A traffic mix names one of the step kinds
below; a new mix is a new data file, and a new configuration new files.

Step kinds (the user's loop, one client, closed: the next step is issued
once the host has read the last one's result):
  render_grad — `blink_torch.api.render_grad` of pixel MSE against a
                target, up to the host's read of the loss;
  render      — `blink_torch.api.render`, up to the image's copy to the
                host.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

from raybench.lib import walkcount
from raybench.lib.trace import STEP_SPAN, Profile

#: Top-level module names that may not be loaded when the result prints.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "blink")


def forbidden_loaded(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN_MODULES, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN_MODULES)


# --------------------------------------------------------------------------
# Finding a cell's files.
# --------------------------------------------------------------------------


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


@dataclasses.dataclass
class CellSpec:
    root: Path
    manifest: dict
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    #: The configuration's scene file (`build(**scene_args)`, `TINY_ARGS`).
    scene: types.ModuleType
    #: The configuration's reference (`loss_and_grads`, `frame_pixels`).
    reference: types.ModuleType

    @property
    def name(self) -> str:
        return self.workload["name"]

    def metrics(self, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics, or its per-layer ones."""
        if not trace:
            return [m for m in self.manifest["end_to_end"]
                    if self.name in m.get("workloads", [self.name])]
        e2e = {m["name"] for m in self.metrics(False)}
        return [m for m in self.manifest["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def cell_spec(root, workload: str, manifest: dict | None = None) -> CellSpec:
    """The cell's files, found by name; the configuration's scene and
    reference (`"reference"`, `render` by default) are loaded here, so a
    name with no file fails at set-up."""
    root = Path(root)
    manifest = manifest or load_json(root / "BENCHMARK.json")
    wl = {w["name"]: w for w in manifest["workloads"]}[workload]
    cfg = {c["name"]: c for c in manifest["configs"]}[wl["config"]]
    config = load_json(root / cfg["file"])
    return CellSpec(root, manifest, wl, config,
                    load_json(root / "raybench" / "traffic" / f"{wl['traffic']}.json"),
                    load_json(root / "raybench" / "limits" / f"{workload}.json"),
                    load_module(root, "scenes", config["scene"]),
                    load_module(root, "reference", config.get("reference", "render")))


def load_module(root, folder: str, name: str) -> types.ModuleType:
    """`raybench/<folder>/<name>.py` under `root`, loaded by path; a name
    with no file raises, naming the path."""
    path = Path(root) / "raybench" / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"raybench: {folder} has no {name!r}: no file {path}")
    spec = importlib.util.spec_from_file_location(f"raybench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(root, metric: str):
    return load_module(root, "metrics", metric).read


# --------------------------------------------------------------------------
# Inputs from the seed.
# --------------------------------------------------------------------------


def scene_arrays(spec: CellSpec, seed: int) -> dict:
    """The configuration's scene, with the traffic's seeded vertex offset
    (a rigid shift of one material's triangles) applied. Groups beyond
    those the program reads (such as `instances`) pass through untouched."""
    arrays = spec.scene.build(**spec.config.get("scene_args", {}))
    off = spec.traffic.get("vertex_offset")
    if off:
        rng = np.random.default_rng([seed % 2**64, 0x0FF5])
        shift = rng.uniform(-off["scale"], off["scale"], 3).astype(np.float32)
        t = arrays["triangles"]
        rows = np.unique(t["idx"][t["material_id"] == off["material"]])
        verts = t["verts"].copy()
        verts[rows] += shift
        t["verts"] = verts
    return arrays


def render_settings(spec: CellSpec) -> dict:
    """The RenderConfig fields: the configuration's, then the traffic's."""
    return {**spec.config.get("render", {}), **spec.traffic["render"]}


def make_target(spec: CellSpec, seed: int, device) -> torch.Tensor:
    """(H, W, 3) target: a seeded coarse grid of colours, made on the
    device, blown up to the image."""
    r = render_settings(spec)
    t = spec.traffic["target"]
    h, w, cells = r["height"], r["width"], t["cells"]
    g = torch.Generator(device=device).manual_seed(seed & (2**63 - 1))
    coarse = torch.rand((cells, cells, 3), generator=g, device=device) * t["scale"]
    return (coarse.repeat_interleave(-(-h // cells), 0)[:h]
            .repeat_interleave(-(-w // cells), 1)[:, :w].contiguous())


def sampler_base(seed: int) -> int:
    """The sampler seed of step 0; step k uses base + k."""
    return random.Random(seed).getrandbits(31)


def pixel_sample(spec: CellSpec, seed: int) -> np.ndarray:
    """Sorted pixel ids a frame check compares, drawn from the seed."""
    r = render_settings(spec)
    n = min(spec.traffic["check"]["pixels"], r["height"] * r["width"])
    rng = np.random.default_rng([seed % 2**64, 0x9E1])
    return np.sort(rng.choice(r["height"] * r["width"], n, replace=False))


# --------------------------------------------------------------------------
# The program under test.
# --------------------------------------------------------------------------


class Program:
    """The cell's scene, backend and step on the program (blink_torch)."""

    def __init__(self, spec: CellSpec, seed: int, device, arrays: dict):
        from blink_torch import api
        from blink_torch.config import RenderConfig
        from blink_torch.kernels.api import make_backend
        from blink_torch.scene.scene import scene_from_numpy

        self.api, self.spec, self.device = api, spec, torch.device(device)
        settings = render_settings(spec)
        self.cfg = RenderConfig(**settings)
        self.kind = spec.traffic["kind"]
        self.scene = scene_from_numpy(arrays).to(self.device)
        t0 = time.perf_counter()
        self.backend = make_backend(self.cfg.backend, self.scene)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.bvh_build_s = time.perf_counter() - t0
        self.params = tuple(spec.traffic.get("params", ()))
        self.target = make_target(spec, seed, self.device) if self.kind == "render_grad" else None
        self.pixels = pixel_sample(spec, seed) if self.kind == "render" else None
        self.work_per_step = self.cfg.width * self.cfg.height * self.cfg.spp

    def step(self, sampler_seed: int):
        """One step, ending in the host's read of its result: (value read,
        what a check keeps, whether the result is finite)."""
        cfg = dataclasses.replace(self.cfg, seed=sampler_seed)
        if self.kind == "render_grad":
            loss, grads = self.api.render_grad(self.scene, cfg, self.target, self.params,
                                               device=self.device, backend=self.backend)
            lv = float(loss)
            return lv, (lv, grads), math.isfinite(lv)
        img = self.api.render(self.scene, cfg, device=self.device, backend=self.backend)
        host = img.cpu().numpy().reshape(-1, 3)
        px = host[self.pixels]
        return px, px, bool(np.isfinite(px).all())


# --------------------------------------------------------------------------
# The check against the reference.
# --------------------------------------------------------------------------


def compare(spec: CellSpec, arrays: dict, seed: int, kept, device,
            dtype=torch.float32) -> dict:
    """The numbers compared, the worst over the kept steps: kept is a list
    of (sampler seed, what Program.step kept). The reference runs in
    `dtype` (bfloat16: the control)."""
    settings = render_settings(spec)
    ref = spec.reference
    out = {}

    def worst(name, v):
        v = float(v)
        out[name] = max(out.get(name, 0.0), v if v == v else float("inf"))  # NaN fails

    for sseed, got in kept:
        if spec.traffic["kind"] == "render_grad":
            lv, grads = got
            target = make_target(spec, seed, device)
            rl, rg = ref.loss_and_grads(arrays, settings, spec.traffic["params"], target, sseed,
                                        device, dtype)
            worst("loss_rel", abs(lv - rl) / max(abs(rl), 1e-30))
            for n, g in rg.items():
                gp = grads[n].to(device=device, dtype=torch.float32)
                worst(f"grad_rel.{n}", float(torch.linalg.vector_norm(gp - g))
                      / max(float(torch.linalg.vector_norm(g)), 1e-30))
        else:
            pid = torch.as_tensor(pixel_sample(spec, seed), device=device)
            rp = ref.frame_pixels(arrays, settings, pid, sseed, device, dtype).cpu().numpy()
            px = np.asarray(got, np.float64)
            diff = np.abs(px - rp)
            worst("px_mean_rel", diff.mean() / max(np.abs(rp).mean(), 1e-30))
            worst("px_off", np.mean(diff > 1e-3 + 1e-3 * np.abs(rp)))
    return out


# --------------------------------------------------------------------------
# One run.
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""

    kind: str
    setup_s: float
    bvh_build_s: float
    step_s: list
    window_s: float
    work_per_step: int
    #: The traced run's host-and-device profile.
    profile: Profile | None = None
    #: The device-only stretch: seconds in which the device ran an
    #: operation, and the stretch's length by the host's clock.
    busy_s: float | None = None
    window_s_traced: float | None = None
    #: The traced run's step times outside the traced stretches.
    step_s_untraced: list | None = None
    walk_work: dict | None = None


def smi(device) -> dict:
    """The card's power limit, SM clock and temperature by nvidia-smi;
    empty where it cannot be read."""
    if torch.device(device).type != "cuda" or not shutil.which("nvidia-smi"):
        return {}
    idx = torch.device(device).index or 0
    q = "power.limit,clocks.sm,temperature.gpu,power.draw"
    try:
        r = subprocess.run(["nvidia-smi", f"--id={idx}", f"--query-gpu={q}",
                            "--format=csv,noheader,nounits"], capture_output=True, text=True,
                           timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return {}
    try:
        vals = [float(x) for x in r.stdout.strip().split(",")]
    except ValueError:
        return {}
    return dict(zip(("power_limit_w", "sm_clock_mhz", "temperature_c", "power_draw_w"), vals))


class Stretches:
    """The traced stretches of a --trace 1 window, one after the other:
    `device` (CUDA activity alone: the device's busy time against the
    host's clock, at a host speed that tracing does not slow) and `host`
    (CPU and CUDA activities: which host op launched each kernel, device
    time by kernel, idle gaps by host op). Each is one warm-up step and
    `steps` active steps, the first starting after `skip_steps` steps."""

    def __init__(self, spec: CellSpec, device, out_dir):
        from torch.profiler import ProfilerActivity

        t = spec.traffic["trace"]
        cpu = [ProfilerActivity.CPU]
        cuda = [ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else []
        self.plan = [("device", cuda or cpu, t["steps"]), ("host", cpu + cuda, t["steps"])]
        self.out_dir = Path(out_dir)
        self.next_start = t["skip_steps"]
        self.prof = None
        self.paths = {}
        self.active = {}  # stretch -> [first active step's start, last one's end, steps]
        self.traced = set()  # steps run under a profiler

    @property
    def done(self) -> bool:
        return not self.plan and self.prof is None

    def before(self, k: int) -> None:
        from torch.profiler import profile, schedule

        if self.prof is not None or not self.plan or k < self.next_start:
            return
        self.name, acts, n = self.plan.pop(0)
        path = self.paths[self.name] = self.out_dir / f"{self.name}.json"
        self.prof = profile(activities=acts,
                            schedule=schedule(wait=0, warmup=1, active=n, repeat=1),
                            on_trace_ready=lambda p: p.export_chrome_trace(str(path)))
        self.prof.start()
        self.first_active, self.left = k + 1, 1 + n

    def after(self, k: int, s0: float, s1: float) -> None:
        if self.prof is None:
            return
        self.traced.add(k)
        if k >= self.first_active:
            w = self.active.setdefault(self.name, [s0, s1, 0])
            w[1], w[2] = s1, w[2] + 1
        self.prof.step()
        self.left -= 1
        if self.left == 0:
            self.prof.stop()
            self.prof = None
            self.next_start = k + 1

    def read(self, ctx) -> None:
        """Fill ctx's busy and window seconds and its host profile."""
        dev = self.paths.get("device")
        if dev is not None and dev.exists() and "device" in self.active:
            events = Profile.events(dev)
            busy = Profile.busy_of(events)
            if busy > 0:
                a = self.active["device"]
                ctx.busy_s, ctx.window_s_traced = busy, a[1] - a[0]
        host = self.paths.get("host")
        ctx.profile = Profile(Profile.events(host)) if host is not None and host.exists() else None


def quarter_rates(step_s, work_per_step: int) -> list[float]:
    """Work a second in each quarter of the window (steps back to back, each
    counted in the quarter where it ends): drift within a run shows here."""
    ends = np.cumsum(step_s)
    if not len(ends):
        return []
    edges = np.linspace(0.0, ends[-1], 5)
    counts = np.histogram(ends, bins=edges)[0]
    return [float(f"{c * work_per_step / (edges[1] - edges[0]):.6g}") for c in counts]


def run_cell(spec: CellSpec, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=print) -> dict:
    """One run of the cell; the result as a dict (the last line's)."""
    device = torch.device(device)

    def note(what):
        log(f"raybench: {time.perf_counter() - t_start:.3f} s {what}")

    note("set-up: imports done")
    arrays = scene_arrays(spec, seed)
    note(f"scene built ({len(arrays['triangles']['idx'])} triangles)")
    prog = Program(spec, seed, device, arrays)
    note(f"program set up (backend {prog.backend.name} built in {prog.bvh_build_s:.3f} s)")
    base = sampler_base(seed)
    for i in range(spec.traffic["warmup_steps"]):
        prog.step(base - 1 - i)
        note(f"warm-up step {i}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    smi_before = smi(device)
    n_keep = spec.traffic["check"]["steps"]
    pick = random.Random(seed ^ 0x5EED)
    kept, steps, failed = [], [], 0
    tmpdir = tempfile.mkdtemp(prefix="raybench-")
    stretches = Stretches(spec, device, tmpdir) if trace else None
    try:
        w0 = time.perf_counter()
        setup_s = w0 - t_start
        k = 0
        while True:
            if stretches is not None:
                stretches.before(k)
            s0 = time.perf_counter()
            with torch.profiler.record_function(STEP_SPAN):
                _, keep, ok = prog.step(base + k)
            s1 = time.perf_counter()
            steps.append(s1 - s0)
            failed += not ok
            item = (base + k, keep)
            if len(kept) < n_keep:
                kept.append(item)
            elif (j := pick.randrange(k + 1)) < n_keep:
                kept[j] = item
            if stretches is not None:
                stretches.after(k, s0, s1)
            k += 1
            if s1 - w0 >= seconds and (stretches is None or stretches.done):
                break
        window_s = s1 - w0
        note(f"window closed: {k} steps in {window_s:.3f} s; rate by quarter of the window "
             f"{quarter_rates(steps, prog.work_per_step)}")
        memory_peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
                       else 0)
        smi_after = smi(device)
        ctx = Context(prog.kind, setup_s, prog.bvh_build_s, steps, window_s,
                      prog.work_per_step)
        if trace:
            stretches.read(ctx)
            ctx.step_s_untraced = [t for i, t in enumerate(steps) if i not in stretches.traced]
            with walkcount.Recorder(type(prog.backend)) as rec:
                prog.step(base + k)
            note("trace read")
            ctx.walk_work = walkcount.walk_work(rec.calls)
            del rec
            note(f"walks counted: {ctx.walk_work}")
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    del prog
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = compare(spec, arrays, seed, kept, device)
    note(f"reference compared on {len(kept)} steps")
    metrics = {}
    for m in spec.metrics(trace):
        v = load_reader(spec.root, m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                    else "cpu"),
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    if ctx.busy_s is not None:
        dev["busy_s"] = ctx.busy_s
        dev["window_s"] = ctx.window_s_traced
    dev.update({f"{k}_before": v for k, v in smi_before.items()})
    dev.update({f"{k}_after": v for k, v in smi_after.items()})
    limits = spec.limits
    table = {n: {"value": v, "limit": limits[n]} for n, v in checks.items()}
    correct = (failed == 0 and len(kept) == n_keep and set(checks) == set(limits)
               and all(v["value"] <= v["limit"] for v in table.values()))
    result = {"correct": correct, "attempted": len(steps), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and ctx.profile is not None:
        result["breakdown"] = {"device_ops": [list(x) for x in ctx.profile.device_ops()],
                               "idle_gaps": [list(x) for x in ctx.profile.idle_gaps()]}
    result["checks"] = table
    return result


def check_lines(result: dict) -> list[str]:
    """Each number compared beside its limit, one a line."""
    return [f"check {n} {v['value']!r} limit {v['limit']!r}"
            for n, v in result["checks"].items()]


def env_for_caches(root) -> None:
    """Kernel caches at fixed paths inside the checkout."""
    os.environ["TRITON_CACHE_DIR"] = str(Path(root) / ".raybench_cache" / "triton")
