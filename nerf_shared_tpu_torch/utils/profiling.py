"""Profiling: a Chrome trace, and the program's spans and host-sync counts.

- ``trace(logdir)``: a ``torch.profiler`` context that writes a Chrome
  trace (``trace.json``, viewable in Perfetto) under ``logdir``.
- ``span(name, unit=None)``: a context around the work of one layer
  (train/step.py's phases, render/renderer.py's frames and host copies,
  apps/serve.py's requests and their encode). It records only while a
  ``torch.profiler`` session runs (``trace``, or a benchmark's traced
  window); otherwise it returns one shared no-op context after a single
  attribute read, with no clock read and no allocation.
- ``spans()``: what the latest recording holds, ``Recorded(spans,
  dropped)``.

A span holds its name, its start and end on ``time.perf_counter_ns``, the
index of its parent (the innermost span open in the same thread when it
opened; -1 for none), a unit id and a count of host syncs. The unit id is
the step for training and the request's sequence number for serving; a
span given none takes its parent's, so the spans of one step or request
share it. Spans stay in memory, at most ``MAX_SPANS`` of them a recording,
with a count of those dropped beyond it; nothing is written during a run.
While recording, each span also opens ``torch.autograd.profiler.
record_function(name)``, so the trace shows the phases over the kernels.

Host syncs: while recording on a CUDA device the recorder sets
``torch.cuda.set_sync_debug_mode("warn")`` (where it was "default") and
counts each synchronizing CUDA call that PyTorch reports against the
innermost open span of the calling thread; a report from a thread with no
open span is not counted. (The autograd engine replays the reports of its
device threads on the thread that called ``backward``.) The reports are
Python warnings, shown once per place by default: while recording, a
filter lets every one through to the counter, which swallows them. The mode, the filter and the previous
``warnings.showwarning`` are restored at the first sync or ``spans()``
after the profiler stops, and when ``trace`` ends; the next span opened
under a profiler after that starts a new recording.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import warnings
from typing import List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

MAX_SPANS = 1 << 18
# the start of the warning PyTorch raises for a synchronizing CUDA call
# under set_sync_debug_mode("warn")
SYNC_WARNING = "called a synchronizing CUDA operation"


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: Optional[int]  # None while the span is open
    parent: int  # index in ``Recorded.spans``; -1 for none
    unit: Optional[int]
    syncs: int  # host syncs while this was the innermost open span


class Recorded(NamedTuple):
    spans: List[Span]
    dropped: int


# an open or closed span: [name, start, end, parent, unit, syncs, index]
_NAME, _START, _END, _PARENT, _UNIT, _SYNCS, _INDEX = range(7)


class Recorder:
    """Spans and host-sync counts of the recordings in this process (the
    module's ``span`` / ``spans`` are the process recorder's)."""

    def __init__(self, limit: int = MAX_SPANS):
        self.limit = limit
        self._lock = threading.Lock()
        self._items: list = []
        self._dropped = 0
        self._stacks: dict = {}  # thread id -> open spans (None: dropped)
        self._armed = None  # (filter entry, sync mode to restore) while recording
        self._shown = warnings.showwarning  # where other warnings go meanwhile

    def span(self, name: str, unit: Optional[int] = None):
        """A context recording ``name`` while a profiler runs (module
        docstring); ``unit`` defaults to the parent span's."""
        if not _autograd_profiler._is_profiler_enabled:
            return _OFF
        return _Open(self, name, unit)

    def spans(self) -> Recorded:
        with self._lock:
            if not _autograd_profiler._is_profiler_enabled:
                self._disarm()
            return Recorded([Span(*r[:_INDEX]) for r in self._items], self._dropped)

    # ------------------------------------------------------------ spans
    def _push(self, name: str, unit: Optional[int]):
        tid = threading.get_ident()
        with self._lock:
            if self._armed is None:
                self._arm()
            stack = self._stacks.setdefault(tid, [])
            top = stack[-1] if stack else None
            if top is not None and not (top[_INDEX] < len(self._items)
                                        and self._items[top[_INDEX]] is top):
                top = None  # opened in an earlier recording
            if unit is None and top is not None:
                unit = top[_UNIT]
            rec = None
            if len(self._items) < self.limit:
                rec = [name, 0, None, -1 if top is None else top[_INDEX], unit, 0,
                       len(self._items)]
                self._items.append(rec)
            else:
                self._dropped += 1
            stack.append(rec)
        return rec

    def _pop(self, rec, end_ns: int):
        tid = threading.get_ident()
        with self._lock:
            if rec is not None:
                rec[_END] = end_ns
            stack = self._stacks[tid]
            stack.pop()
            if not stack:
                del self._stacks[tid]

    # ------------------------------------------------------ host syncs
    def _arm(self):
        """Start a recording (under the lock): clear the spans, let every
        sync warning through to ``_showwarning`` and turn the reports on."""
        self._items, self._dropped = [], 0
        warnings.filterwarnings("always", message=SYNC_WARNING)
        entry = warnings.filters[0]
        self._shown = warnings.showwarning
        warnings.showwarning = self._showwarning
        mode = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            try:
                if torch.cuda.get_sync_debug_mode() == 0:
                    torch.cuda.set_sync_debug_mode("warn")
                    mode = 0
            except (AssertionError, RuntimeError):  # no CUDA in this build
                pass
        self._armed = (entry, mode)

    def _disarm(self):
        """End a recording (under the lock): restore what ``_arm`` set."""
        if self._armed is None:
            return
        entry, mode = self._armed
        self._armed = None
        if mode is not None:
            torch.cuda.set_sync_debug_mode(mode)
        with contextlib.suppress(ValueError):
            warnings.filters.remove(entry)
        if warnings.showwarning == self._showwarning:
            warnings.showwarning = self._shown

    def _showwarning(self, message, category, filename, lineno, file=None, line=None):
        if not str(message).startswith(SYNC_WARNING):
            self._shown(message, category, filename, lineno, file, line)
            return
        with self._lock:
            if not _autograd_profiler._is_profiler_enabled:
                self._disarm()
                return
            stack = self._stacks.get(threading.get_ident())
            if stack and stack[-1] is not None:
                stack[-1][_SYNCS] += 1


class _Open:
    """A span being recorded."""

    __slots__ = ("recorder", "name", "unit", "rec", "fn")

    def __init__(self, recorder: Recorder, name: str, unit: Optional[int]):
        self.recorder, self.name, self.unit = recorder, name, unit

    def __enter__(self):
        self.rec = self.recorder._push(self.name, self.unit)
        self.fn = _autograd_profiler.record_function(self.name)
        self.fn.__enter__()
        if self.rec is not None:
            self.rec[_START] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.fn.__exit__(*exc)
        self.recorder._pop(self.rec, end)
        return False


_OFF = contextlib.nullcontext()
RECORDER = Recorder()
span = RECORDER.span
spans = RECORDER.spans


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (the CPU, and the card when there is one) and
    write ``logdir``/trace.json; the spans the block recorded stay
    readable through ``spans()``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        spans()  # the profiler has stopped: end the recording
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
