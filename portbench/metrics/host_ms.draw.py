"""host_ms.draw: the host ms a training step spends in the program's
``train_step.draw``: the pixel draw, the render seed, the rays and their
packing, the parameters (sample_pixels, pixel_rays, pack_ray_batch). Read
from the program's own spans in the traced window (core/program_spans.py).
Moves ``train_rays_per_s`` while the step is host-bound."""

from portbench.core.program_spans import phase_host_ms


def read(r):
    return phase_host_ms(r, "draw")
