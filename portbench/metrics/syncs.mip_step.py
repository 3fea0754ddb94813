"""syncs.mip_step: ``syncs.step`` for mip-NeRF's training step (traffic
kind ``train_mip``): the host syncs a step by the program's counter over
the traced window's ``train_step`` spans and their phases
(core/program_spans.py). Moves ``train_rays_per_s``."""

import dataclasses

from portbench.core.program_spans import step_syncs


def read(r):
    return step_syncs(dataclasses.replace(r, kind="train")) if r.kind == "train_mip" else None
