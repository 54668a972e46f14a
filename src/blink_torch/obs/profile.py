"""Profiling hooks (counterpart of `blink.obs.profile`).

`trace(logdir)` records a region with torch.profiler (the host, and the
CUDA device where there is one) and writes a Chrome trace into `logdir`,
which tensorboard's profiler plugin and chrome://tracing read; `timed`
wall-clocks a block, as the CLI's render does.

The pipeline marks its own stages and counts its walk lanes, but only
while a torch profiler records (`trace`, `render --profile <dir>`, or any
`torch.profiler.profile` of the caller's). There is no switch: otherwise
`span` returns one shared no-op context and `count` returns at once, so
nothing is recorded or allocated.

`span(name)` is a `record_function("blink." + name)` range: a CPU user
annotation in the same trace as the kernels it launches. A kernel belongs
to the innermost `blink.*` range open on the thread that launched it.

  blink.render             render_image / render_rows: a frame, or a
                           step's forward
  blink.backward           render_grad's backward
  blink.camera             generate_rays
  blink.sampler            the sampler's keys and draws, inside any stage
  blink.closest            Backend.intersect (the closest-hit walks)
  blink.shadow             Backend.occluded (the any-hit walks)
  blink.refine             hit refinement, shading rows and textures
  blink.nee                next-event estimation (light rows, samples)
  blink.bounce             li_path's radiance update, next direction,
                           throughput and roulette
  blink.compact            li_path's compaction and its inverse gather
  blink.soft               li_direct_soft's sphere-soft and mesh-soft terms
  blink.scatter_tri_verts  refine's vertex scatter, in the backward
                           (launched on autograd's device thread)

`count(name, value)` adds to a counter; `count_later(names, fn)` adds
fn()'s values to counters `names` when they are next read, so that work
which must not run inside the recording (a counting pass) runs after it;
`counts()` reads the sums (one device sync) and `reset_counts()` clears
them. Counters:

  walk_lanes.closest, walk_lanes.anyhit  lanes each walk call is launched
                                         over
  walk_live.closest, walk_live.anyhit    its live lanes: intersect's
                                         `alive` ones (all without a
                                         mask), occluded's with t_far > 0
  sampler_rows.kernel, sampler_rows.plain
                                         rows each core/sampler.py call
                                         hashes: in csrc/sampler_hash.cu
                                         (a CUDA key) or in plain torch
                                         (a CPU key)
  tlas_pops, blas_pops, tri_tests, blas_entries (.closest, .anyhit)
                                         the tlas backend's walk calls:
                                         TLAS node pops, BLAS node pops,
                                         triangle tests and BLAS walks
                                         begun (count_later: the kernel's
                                         counting build, or the plain
                                         walk's counts on the CPU, over a
                                         sample of each call's lanes kept
                                         while recording, scaled to the
                                         call's lanes)

A masked walk call counts its live lanes on the device (two or three
launches: the mask, its cast and the sum), and a tlas walk call copies its
sample of lanes (one launch), only while a profiler records.
"""
from __future__ import annotations

import contextlib
import time

import torch

#: The profiler's own enabled state on the calling thread (autograd's
#: device threads inherit it from the thread that runs the backward).
recording = torch._C._autograd._profiler_enabled

_OFF = contextlib.nullcontext()

#: Counter name -> values recorded (Python ints and 0-d device tensors).
_counts: dict[str, list] = {}
#: (counter names, fn) whose values counts() adds before it sums.
_later: list = []


@contextlib.contextmanager
def trace(logdir: str | None):
    """Yields the torch.profiler.profile (its key_averages() after the
    block), or None without a logdir."""
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(logdir),
                 acc_events=True) as prof:
        yield prof


def span(name: str):
    """The range `blink.<name>` while a profiler records; else a shared
    no-op context."""
    if recording():
        return torch.profiler.record_function("blink." + name)
    return _OFF


def count(name: str, value) -> None:
    """Add `value` (an int, or a 0-d tensor left unsynchronized) to the
    counter `name` while a profiler records."""
    if recording():
        _counts.setdefault(name, []).append(value)


def count_later(names, fn) -> None:
    """While a profiler records, have the next counts() call fn() and add
    its values (one a name, as `count` takes them) to the counters
    `names`."""
    if recording():
        _later.append((tuple(names), fn))


def counts() -> dict[str, int]:
    """Each counter's sum since the last reset_counts(), count_later's
    values taken first; the tensors among the values are read in one copy
    to the host."""
    while _later:
        names, fn = _later.pop(0)
        for name, v in zip(names, fn(), strict=True):
            _counts.setdefault(name, []).append(v)
    out = {}
    tensors = []  # (name, 0-d tensor)
    for name, values in _counts.items():
        out[name] = 0
        for v in values:
            if torch.is_tensor(v):
                tensors.append((name, v))
            else:
                out[name] += int(v)
    if tensors:
        dev = tensors[0][1].device
        host = torch.stack([v.to(device=dev, dtype=torch.int64) for _, v in tensors]).tolist()
        for (name, _), v in zip(tensors, host):
            out[name] += v
    return out


def reset_counts() -> None:
    _counts.clear()
    _later.clear()


@contextlib.contextmanager
def timed(out: dict, key: str):
    """Wall-clock a block into out[key] (the block synchronizes the device
    itself where it must)."""
    t0 = time.perf_counter()
    yield
    out[key] = time.perf_counter() - t0
