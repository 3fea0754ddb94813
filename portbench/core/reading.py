"""What a per-layer metric's reader gets from a traced run."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from portbench.core.trace import Spans, Window


@dataclasses.dataclass
class Reading:
    """``kind``: the traffic kind ("train", "serve"); ``scene`` and ``net``:
    the configuration's sizes (core/inputs.py); ``precision``: the
    program's compute precision ("fp32", "bf16"); ``units``: steps or
    frames completed in the traced window; ``window``: its device
    operations (None when the profiler recorded none); ``spans``: the
    benchmark's host spans; ``launches``: each kernel's launches in the
    window by the program's counters; ``host``: per-unit host times in ms
    (train: ``step_ms``; serve: ``client_ms``, ``render_ms``)."""

    kind: str
    scene: dict
    net: dict
    precision: str
    units: int
    window: Optional[Window]
    spans: Spans
    launches: Dict[str, int]
    host: Dict[str, List[float]]

    def counted(self, counter: str, *kernels: str) -> Optional[float]:
        """Device seconds of ``kernels`` in the window, or None when the
        trace holds another number of them than the program's launch
        counter ``counter`` (core/program.py) says it launched (the
        profiler dropped some), or none."""
        if self.window is None:
            return None
        seconds, n = self.window.kernel_seconds(*kernels)
        if n == 0 or n != self.launches.get(counter, -1):
            return None
        return seconds
