"""host_ms.backward: the host ms a training step spends in the program's
``train_step.backward``: zero_grad, loss.backward() (autograd and kernel
B2's wrapper and launches) and the loss map. Read from the program's own
spans in the traced window (core/program_spans.py). Moves
``train_rays_per_s`` while the step is host-bound."""

from portbench.core.program_spans import phase_host_ms


def read(r):
    return phase_host_ms(r, "backward")
