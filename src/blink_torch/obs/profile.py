"""Profiling hooks (counterpart of `blink.obs.profile`).

`trace(logdir)` records a region with torch.profiler (the host, and the
CUDA device where there is one) and writes a Chrome trace into `logdir`,
which tensorboard's profiler plugin and chrome://tracing read;
`annotate(name)` is a helper for callers that want a named range of
their own in that timeline (the pipeline marks none itself); `timed`
wall-clocks a block, as the CLI's render does.
"""
from __future__ import annotations

import contextlib
import time

import torch


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


def annotate(name: str):
    """A named range inside a trace, for a caller to mark a stage of its
    own."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def timed(out: dict, key: str):
    """Wall-clock a block into out[key] (the block synchronizes the device
    itself where it must)."""
    t0 = time.perf_counter()
    yield
    out[key] = time.perf_counter() - t0
