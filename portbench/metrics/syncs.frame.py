"""syncs.frame: the host syncs a served frame, by the program's counter
(PyTorch's reports of synchronizing CUDA calls) over the traced window's
``request`` spans and everything under them, the frame's host copy
included (core/program_spans.py). Moves ``frame_ms``."""

from portbench.core.program_spans import frame_syncs


def read(r):
    return frame_syncs(r)
