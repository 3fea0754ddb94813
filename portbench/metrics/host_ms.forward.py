"""host_ms.forward: the host ms a training step spends in the program's
``train_step.forward``: nerf_loss: the renderer and kernel B1's wrapper
and launches. Read from the program's own spans in the traced window
(core/program_spans.py). Moves ``train_rays_per_s`` while the step is
host-bound."""

from portbench.core.program_spans import phase_host_ms


def read(r):
    return phase_host_ms(r, "forward")
