"""The traced run: the device's operations from ``torch.profiler`` (CUDA
activity, the card's own clock), the benchmark's host spans around its
calls into the program, and what the per-layer metrics read from them.

The profiler starts before the window on an idle card; the window opens
with a one-element fill on that idle card, so the first device operation
in the trace is that marker and its start is the window's start on the
device's clock. Host spans (``time.perf_counter_ns``) map onto that clock
by the marker's offset, accurate to a launch's latency.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch


def union_seconds(intervals: List[Tuple[int, int]]) -> float:
    """Seconds covered by the union of [start_ns, end_ns) intervals:
    overlapping operations count once."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e9


def gaps(intervals: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The stretches of [lo, hi) that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


class Spans:
    """Host spans: (name, start_ns, end_ns) on ``time.perf_counter_ns``,
    from any thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self.items: List[Tuple[str, int, int]] = []

    def add(self, name: str, start: int, end: int):
        with self._lock:
            self.items.append((name, start, end))

    def named(self, name: str) -> List[Tuple[int, int]]:
        return [(s, e) for n, s, e in self.items if n == name]


@dataclasses.dataclass
class Window:
    """What a traced window left: device operations clipped to it (name,
    start_ns, end_ns on the device's clock), its length, and the offset
    that maps host times onto the device's clock."""

    ops: List[Tuple[str, int, int]]
    start: int
    end: int
    host_offset: int

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    def busy_seconds(self) -> float:
        return union_seconds([(s, e) for _, s, e in self.ops])

    def kernel(self, *names: str) -> List[Tuple[int, int]]:
        """Intervals of the operations whose name contains one of ``names``
        as the kernel's own name (before its argument list)."""
        pats = [re.compile(rf"(^|[\s:]){re.escape(k)}($|<)") for k in names]
        return [(s, e) for n, s, e in self.ops
                if any(p.search(n.split("(", 1)[0].strip()) for p in pats)]

    def kernel_seconds(self, *names: str) -> Tuple[float, int]:
        iv = self.kernel(*names)
        return sum(e - s for s, e in iv) / 1e9, len(iv)


class DeviceTrace:
    """``torch.profiler`` over one window of the program, on one card."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t0 = None
        self.marker = torch.zeros(1, device=device)

    def open(self) -> int:
        """Start the profiler and open the window; returns the window's
        start on the host clock."""
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter_ns()
        self.marker.fill_(1.0)
        return self.t0

    def close(self, t_end: int) -> Optional[Window]:
        """Stop the profiler; ``t_end`` is the window's end on the host
        clock. Returns None when the trace holds no device operation."""
        torch.cuda.synchronize(self.device)
        self.prof.__exit__(None, None, None)
        ops = []
        for ev in self.prof.profiler.kineto_results.events():
            if "cuda" not in str(ev.device_type()).lower():
                continue
            start = _start_ns(ev)
            ops.append((ev.name(), start, start + _duration_ns(ev)))
        self.prof = None
        if not ops:
            return None
        ops.sort(key=lambda o: o[1])
        start = ops[0][1]
        end = start + (t_end - self.t0)
        clipped = [(n, max(s, start), min(e, end)) for n, s, e in ops if e > start and s < end]
        return Window(clipped, start, end, start - self.t0)


def _start_ns(ev) -> int:
    if hasattr(ev, "start_ns"):
        return int(ev.start_ns())
    return int(ev.start_us() * 1000)


def _duration_ns(ev) -> int:
    if hasattr(ev, "duration_ns"):
        return int(ev.duration_ns())
    return int(ev.duration_us() * 1000)


def short_name(name: str) -> str:
    """A device operation's name without its argument list, at most 96
    characters."""
    base = name.replace("(anonymous namespace)", "(anon)").replace("void ", "")
    depth, cut = 0, len(base)
    for i, ch in enumerate(base):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and not base.startswith("(anon)", i):
            cut = i
            break
    return base[:cut].strip()[:96]


def breakdown(win: Window, spans: Spans, labels: Dict[str, str]) -> dict:
    """The ten device operations that took most time, and the idle time
    sorted by what the host was doing (the innermost of the spans named in
    ``labels`` that covers each idle stretch's middle; ``labels`` maps a
    span name to its label, innermost first)."""
    by_op: Dict[str, int] = {}
    for n, s, e in win.ops:
        k = short_name(n)
        by_op[k] = by_op.get(k, 0) + (e - s)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    host = []
    for name in labels:
        iv = sorted((s + win.host_offset, e + win.host_offset) for s, e in spans.named(name))
        host.append((name, [s for s, _ in iv], [e for _, e in iv]))
    idle: Dict[str, List[int]] = {}
    for s, e in gaps([(s, e) for _, s, e in win.ops], win.start, win.end):
        mid = (s + e) // 2
        label = "outside the benchmark's spans"
        for name, starts, ends in host:
            # the spans of one name do not overlap: the last one starting
            # at or before mid is the only one that can cover it
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and mid < ends[i]:
                label = labels[name]
                break
        idle.setdefault(label, []).append(e - s)
    gap_rows = sorted(((f"{k}: {len(v)} gaps, longest {max(v) / 1e6:.3f} ms", sum(v) / 1e9)
                       for k, v in idle.items()), key=lambda r: -r[1])[:10]
    return {"device_ops": [[k, v / 1e9] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gap_rows]}
