"""Device time by the program's own stages, and its walk-lane counters.

blink_torch marks its stages with `blink.*` ranges (record_function, a CPU
user annotation in the trace) while a profiler records. A kernel belongs to
the innermost `blink.*` range open on the thread that launched it, at the
moment of its runtime launch call (matched by correlation id): a stage's
self time, since a nested range (`blink.sampler` inside `blink.camera`)
keeps its own kernels. A kernel launched on a thread with no range open
(autograd's device thread outside `blink.scatter_tri_verts`) belongs to no
stage.

Reads only the host profile's events (`raybench.lib.trace.Profile`), and
the counters through `blink_torch.obs.profile.counts()`; where the program
marks no such range or keeps no such counter, a reading is None.
"""
from __future__ import annotations

import bisect
import weakref
from collections import defaultdict

#: The start of every stage range's name.
PREFIX = "blink."

_by_profile = weakref.WeakKeyDictionary()  # Profile -> (seconds by stage, stages opened)


class _Ranges:
    """One thread's `blink.*` ranges, sorted by start, each with the index
    of the range it nests in (-1: none)."""

    def __init__(self, ranges):
        # Ties at the start: the longer (enclosing) range first.
        self.ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
        self.starts = [r[0] for r in self.ranges]
        self.parent, stack = [], []
        for i, (s, _, _) in enumerate(self.ranges):
            while stack and self.ranges[stack[-1]][1] < s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def innermost(self, ts: float) -> str | None:
        """The name of the innermost range that holds ts."""
        i = bisect.bisect_right(self.starts, ts) - 1
        while i >= 0 and self.ranges[i][1] < ts:
            i = self.parent[i]
        return self.ranges[i][2] if i >= 0 else None


def attribute(profile) -> tuple[dict, set]:
    """({stage or None: device seconds of the window's kernels}, {stages
    whose range opened}), stage names without the prefix."""
    if profile in _by_profile:
        return _by_profile[profile]
    ranges = {tid: _Ranges([r for r in ops if r[2].startswith(PREFIX)])
              for tid, ops in profile.host.items()}
    opened = {r[2][len(PREFIX):] for rs in ranges.values() for r in rs.ranges}
    by = defaultdict(float)
    for e in profile.kernels:
        where = profile.launch.get((e.get("args") or {}).get("correlation"))
        name = ranges[where[0]].innermost(where[1]) if where and where[0] in ranges else None
        by[name[len(PREFIX):] if name else None] += e["dur"] * 1e-6
    _by_profile[profile] = dict(by), opened
    return _by_profile[profile]


def stage_ms(ctx, stage: str) -> float | None:
    """Device ms a step of the kernels whose innermost range is
    `blink.<stage>`; None where that range never opened (or no kernel
    ran: a trace of the CPU)."""
    p = ctx.profile
    if p is None or not p.n_steps or not p.kernels:
        return None
    by, opened = attribute(p)
    if stage not in opened:
        return None
    return by.get(stage, 0.0) * 1e3 / p.n_steps


def live_share(counts: dict) -> float | None:
    """Live lanes over the lanes the walks were launched over, in %, from
    `walk_live.*` and `walk_lanes.*` counters."""
    lanes = sum(v for k, v in counts.items() if k.startswith("walk_lanes."))
    live = sum(v for k, v in counts.items() if k.startswith("walk_live."))
    return 100.0 * live / lanes if lanes else None


def walk_live_share() -> float | None:
    """live_share of the program's counters, as recorded while the traced
    stretches' profilers recorded."""
    try:
        from blink_torch.obs import profile
    except ImportError:
        return None
    counts = getattr(profile, "counts", None)
    return None if counts is None else live_share(counts())
