"""host_ms.adam: the host ms a training step spends in the program's
``train_step.adam``: apply_gradients (Adam), the EMA and the aux values'
detach. Read from the program's own spans in the traced window
(core/program_spans.py). Moves ``train_rays_per_s`` while the step is
host-bound."""

from portbench.core.program_spans import phase_host_ms


def read(r):
    return phase_host_ms(r, "adam")
