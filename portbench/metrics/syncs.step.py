"""syncs.step: the host syncs a training step, by the program's counter
(PyTorch's reports of synchronizing CUDA calls) over the traced window's
``train_step`` spans and their phases (core/program_spans.py). A sync
makes the host wait for the card inside the step. Moves
``train_rays_per_s``."""

from portbench.core.program_spans import step_syncs


def read(r):
    return step_syncs(r)
