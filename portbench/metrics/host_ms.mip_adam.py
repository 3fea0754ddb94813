"""host_ms.mip_adam: ``host_ms.adam`` for mip-NeRF's training step (traffic
kind ``train_mip``): the host ms a step spends in the program's
``train_step.adam`` (Adam at the delayed log-linear rate), read from the
program's own spans in the traced window (core/program_spans.py). Moves
``train_rays_per_s`` while the step is host-bound."""

import dataclasses

from portbench.core.program_spans import phase_host_ms


def read(r):
    if r.kind != "train_mip":
        return None
    return phase_host_ms(dataclasses.replace(r, kind="train"), "adam")
