"""The two-level walk's work, from the program's own counters, and its
roofline bound (csrc/wide_walk.cu's tlas_wide_group_walk, the `tlas`
backend).

While a profiler records, blink_torch's `tlas` backend keeps a sample of
each walk call's lanes; when the counters are read, after the window, it
walks the sample through the kernel's counting build and adds the call's
work, scaled to its lanes, to `tlas_pops.*`, `blas_pops.*`, `tri_tests.*`
and `blas_entries.*` (BLAS walks begun), `.closest` and `.anyhit`. So the
traced stretches time the production kernel. Every backend adds its live
lanes to `walk_live.*` (raybench/lib/spans.py). A --trace 1 run records
them in
both traced stretches, each of the traffic's `trace.steps` active steps
(a profiler's warm-up step records nothing), so a step's work is their
sum over STRETCHES x the host profile's steps. Where the program keeps no
such counter (a flat backend, or a program without the `tlas` backend),
every reading is None.

Model, as walkcount.py's for the flat walk (one H100 SXM at its 700 W
data-sheet rates, 67 TFLOP/s FP32 and 3.35 TB/s):
  - a TLAS pop and a BLAS pop: POP_OPS, 8 slab tests of 20 FP32
    operations;
  - a triangle test: TEST_OPS, 35 (Möller–Trumbore);
  - an instance entry: ENTRY_OPS, the ray into object space, o by the
    3x4 affine (9 multiplies, 9 adds), d by its 3x3 part (9 multiplies,
    6 adds), and the 3 reciprocals of the new direction;
  - bytes: RAY_BYTES a live ray (o and d read, t and prim written).
The bound is the larger of operations over the FP32 rate and bytes over
the memory rate."""
from __future__ import annotations

from raybench.lib import layers
from raybench.lib.walkcount import FP32_FLOPS, HBM_BYTES_S, POP_OPS, RAY_BYTES, TEST_OPS

ENTRY_OPS = 9 + 9 + 9 + 6 + 3
#: The traced stretches of a --trace 1 run that record the counters.
STRETCHES = 2
#: The two-level walk's kernels, by name.
KERNELS = ("tlas_wide_group_walk",)
COUNTERS = ("tlas_pops", "blas_pops", "tri_tests", "blas_entries", "walk_live")


def _program_counts() -> dict:
    try:
        from blink_torch.obs import profile
    except ImportError:
        return {}
    counts = getattr(profile, "counts", None)
    return {} if counts is None else counts()


def work(counts: dict | None = None) -> dict | None:
    """Each counter summed over closest and any hit; None where the program
    counted no BLAS walk."""
    counts = _program_counts() if counts is None else counts
    if not any(k.startswith("blas_entries.") for k in counts):
        return None
    return {n: sum(v for k, v in counts.items() if k.startswith(n + "."))
            for n in COUNTERS}


def bound_s(w: dict) -> tuple[float, str]:
    """(seconds, 'operations' or 'bytes'): the least time the counted
    walks could take on the card."""
    ops = (POP_OPS * (w["tlas_pops"] + w["blas_pops"]) + TEST_OPS * w["tri_tests"]
           + ENTRY_OPS * w["blas_entries"])
    t_ops = ops / FP32_FLOPS
    t_bytes = RAY_BYTES * w["walk_live"] / HBM_BYTES_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def roofline(ctx) -> float | None:
    """The bound of a step's two-level walks over their device time a
    profiled step, in %."""
    ms = layers.walk_ms(ctx, KERNELS)
    w = work()
    if ms is None or w is None:
        return None
    steps = STRETCHES * ctx.profile.n_steps
    return 100.0 * bound_s(w)[0] / steps / (ms * 1e-3)


def entries_per_live_lane() -> float | None:
    """BLAS walks begun over the live lanes the walks were launched with."""
    w = work()
    return None if w is None or not w["walk_live"] else w["blas_entries"] / w["walk_live"]
