"""Reading a torch.profiler trace (the Chrome trace JSON it exports): the
window the harness's step spans cover, the device's busy time in it, device
time by kernel, the kernels a host op launched, and the idle gaps named by
what the host was doing."""
from __future__ import annotations

import bisect
import json
from collections import defaultdict

#: The harness's span around each step (record_function).
STEP_SPAN = "raybench.step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_s(intervals, lo: float, hi: float) -> float:
    """Seconds covered by the union of (start, end) intervals in µs,
    clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6


def gaps(intervals, lo: float, hi: float):
    """(start, end) µs of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if e <= t:
            continue
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


class Profile:
    """The events of one exported trace. Times in µs, as the trace has
    them; every reading in seconds."""

    def __init__(self, events: list[dict]):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        steps = sorted((e["ts"], e["ts"] + e["dur"], e.get("tid")) for e in xs
                       if e.get("name") == STEP_SPAN and e.get("cat") == "user_annotation")
        self.n_steps = len(steps)
        self.lo = steps[0][0] if steps else 0.0
        self.hi = max(s[1] for s in steps) if steps else 0.0
        self.main_tid = steps[0][2] if steps else None

        def inside(e):
            return self.lo <= e["ts"] <= self.hi

        self.device = [e for e in xs if e.get("cat") in DEVICE_CATS and inside(e)]
        self.kernels = [e for e in self.device if e.get("cat") == "kernel"]
        self.host = defaultdict(list)  # tid -> cpu ops and spans, by start
        self.spans = []  # the harness's own spans, by start
        for e in xs:
            if e.get("cat") in ("cpu_op", "user_annotation"):
                self.host[e.get("tid")].append((e["ts"], e["ts"] + e["dur"], e["name"]))
            if e.get("cat") == "user_annotation" and e["name"].startswith("raybench."):
                self.spans.append((e["ts"], e["ts"] + e["dur"], e["name"]))
        for v in self.host.values():
            v.sort()
        self.spans.sort()
        self.launch = {}  # correlation id -> (tid, ts) of the runtime call
        for e in xs:
            if e.get("cat") == "cuda_runtime":
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    self.launch[corr] = (e.get("tid"), e["ts"])

    @staticmethod
    def events(path) -> list[dict]:
        with open(path) as fh:
            data = json.load(fh)
        return data["traceEvents"] if isinstance(data, dict) else data

    @staticmethod
    def busy_of(events) -> float:
        """Seconds covered by the union of all device events of a trace."""
        iv = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS and "dur" in e]
        return union_s(iv, float("-inf"), float("inf")) if iv else 0.0

    def kernel_s(self, keep) -> float:
        """Device seconds of the window's kernels for which keep(event)."""
        return sum(e["dur"] for e in self.kernels if keep(e)) * 1e-6

    @staticmethod
    def _innermost(ops, ts, scan: int):
        """The name of the latest-starting interval of `ops` (sorted by
        start) that holds ts, looking back `scan` entries; None."""
        i = bisect.bisect_right(ops, (ts, float("inf"), ""))
        for s, e, name in reversed(ops[max(0, i - scan):i]):
            if s <= ts <= e:
                return name
        return None

    def launched_under(self, op_names, prefix: bool = False) -> set:
        """Correlation ids of the kernels whose launch call lies inside a
        host op named in `op_names` (with `prefix`, whose name starts with
        one of them)."""
        op_names = tuple(op_names)

        def named_as(name):
            return name.startswith(op_names) if prefix else name in op_names

        named = {tid: [x for x in ops if named_as(x[2])] for tid, ops in self.host.items()}
        out = set()
        for e in self.kernels:
            corr = (e.get("args") or {}).get("correlation")
            where = self.launch.get(corr)
            if where is not None and self._innermost(named.get(where[0], []), where[1], 8):
                out.add(corr)
        return out

    def device_ops(self, top: int = 10):
        """[(kernel name, seconds)] of the kernels that took most time."""
        by = defaultdict(float)
        for e in self.device:
            by[e["name"]] += e["dur"] * 1e-6
        return sorted(by.items(), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10):
        """[(host op, seconds)]: the device's idle time in the window,
        summed by the innermost host op of the stepping thread open at each
        gap's middle (else the harness's span: the host in Python between
        torch ops)."""
        by = defaultdict(float)
        for s, e in gaps([(x["ts"], x["ts"] + x["dur"]) for x in self.device], self.lo, self.hi):
            mid = 0.5 * (s + e)
            name = self._innermost(self.host.get(self.main_tid, []), mid, 256)
            if name is None:
                span = self._innermost(self.spans, mid, 64)
                name = f"{span}: outside torch ops" if span else "host"
            by[name] += (e - s) * 1e-6
        return sorted(by.items(), key=lambda kv: -kv[1])[:top]
