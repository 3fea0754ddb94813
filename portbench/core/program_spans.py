"""The program's own spans (``nerf_shared_tpu_torch/utils/profiling.py``)
in a traced window, for the per-layer metrics that read them.

The program records its spans on ``time.perf_counter_ns``, the clock of the
benchmark's own spans, so ``Window.host_offset`` maps them onto the device
trace's clock. A span is in the window when it starts and ends inside
``[win.start, win.end]`` less the offset. Every reader returns None when
the program records no spans (a program without them), when it dropped
some, or when the window holds none of those it reads.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional


class ProgramSpans:
    """The program's spans and the traced window they are read against."""

    def __init__(self, items, win):
        self.items, self.win = items, win
        self.lo, self.hi = win.start - win.host_offset, win.end - win.host_offset
        self.children: Dict[int, List[int]] = {}
        for i, s in enumerate(items):
            if s.parent >= 0:
                self.children.setdefault(s.parent, []).append(i)

    def named(self, name: str) -> List[int]:
        """Indices of the closed spans called ``name`` inside the window."""
        return [i for i, s in enumerate(self.items)
                if s.name == name and s.end_ns is not None
                and self.lo <= s.start_ns and s.end_ns <= self.hi]

    def child(self, i: int, name: str) -> List[int]:
        return [j for j in self.children.get(i, ()) if self.items[j].name == name]

    def ms(self, i: int) -> float:
        s = self.items[i]
        return (s.end_ns - s.start_ns) / 1e6

    def syncs(self, i: int) -> int:
        """Host syncs of span ``i`` and all its descendants."""
        total, todo = 0, [i]
        while todo:
            j = todo.pop()
            total += self.items[j].syncs
            todo.extend(self.children.get(j, ()))
        return total


def load(r) -> Optional[ProgramSpans]:
    """The program's spans against ``r``'s window, or None (module
    docstring)."""
    if r.window is None:
        return None
    try:
        from nerf_shared_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    rec = read()
    if rec.dropped or not rec.spans:
        return None
    return ProgramSpans(rec.spans, r.window)


def _steps(r):
    ps = load(r) if r.kind == "train" else None
    steps = ps.named("train_step") if ps is not None else []
    return (ps, steps) if steps else (None, [])


def phase_host_ms(r, phase: str) -> Optional[float]:
    """Host ms a step in ``train_step.<phase>``."""
    ps, steps = _steps(r)
    if not steps:
        return None
    return sum(ps.ms(j) for i in steps for j in ps.child(i, f"train_step.{phase}")) / len(steps)


def step_syncs(r) -> Optional[float]:
    """Host syncs a step: the counter over the window's ``train_step``
    spans and their descendants."""
    ps, steps = _steps(r)
    if not steps:
        return None
    return sum(ps.syncs(i) for i in steps) / len(steps)


def _serve(r):
    return load(r) if r.kind == "serve" else None


def engine_host_ms(r) -> Optional[float]:
    """Mean host ms of a ``frame`` less its ``frame.copy``."""
    ps = _serve(r)
    frames = ps.named("frame") if ps is not None else []
    if not frames:
        return None
    return statistics.fmean(ps.ms(i) - sum(ps.ms(j) for j in ps.child(i, "frame.copy"))
                            for i in frames)


def encode_host_ms(r) -> Optional[float]:
    """Mean host ms of a ``request.encode``."""
    ps = _serve(r)
    enc = ps.named("request.encode") if ps is not None else []
    return statistics.fmean(ps.ms(i) for i in enc) if enc else None


def frame_syncs(r) -> Optional[float]:
    """Host syncs a frame: the counter over the window's ``request`` spans
    and their descendants, over the requests."""
    ps = _serve(r)
    reqs = ps.named("request") if ps is not None else []
    return sum(ps.syncs(i) for i in reqs) / len(reqs) if reqs else None
