"""Timing and profiling helpers.

Counterpart of ``nerf_shared_tpu/utils/profiling.py``:

- ``timed``: wall-clock time of a call, the card synchronised before and
  after each call, so queued work and start-up do not leak into it;
- ``rays_per_sec``: the train / render throughput counter;
- ``trace``: a ``torch.profiler`` context that writes a Chrome trace
  (``trace.json``, viewable in Perfetto) under ``logdir``.

Nothing on the main path imports it, as in JAX (``chip_smoke.py
--profile`` profiles the frames and steps it runs).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn: Callable, *args, warmup: int = 1, iters: int = 10, **kwargs):
    """Run ``fn(*args, **kwargs)`` ``warmup`` times, then ``iters`` times
    timed; returns (mean seconds a call, the last result). The card is
    synchronised around each call."""
    result = None
    for _ in range(warmup):
        _sync()
        result = fn(*args, **kwargs)
        _sync()
    total = 0.0
    for _ in range(iters):
        _sync()
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        _sync()
        total += time.perf_counter() - t0
    return total / max(iters, 1), result


def rays_per_sec(n_rays: int, seconds: float) -> float:
    return n_rays / seconds if seconds > 0 else float("inf")


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (the CPU, and the card when there is one) and
    write ``logdir``/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
