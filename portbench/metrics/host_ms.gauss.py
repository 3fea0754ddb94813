"""host_ms.gauss: the host ms a mip-NeRF training step spends in the
program's ``train_step.gauss`` spans (the frustum Gaussians of both passes,
the blur of the coarse weights and the resampling; render/renderer.py
``render_rays_mip``), summed over each step's spans inside the traced
window (core/program_spans.py). None when the program records no such
span. Moves ``train_rays_per_s`` while the step is host-bound."""

from portbench.core.program_spans import load

SPAN = "train_step.gauss"


def read(r):
    if r.kind != "train_mip":
        return None
    ps = load(r)
    steps = ps.named("train_step") if ps is not None else []
    if not steps:
        return None
    total, found = 0.0, 0
    for i in steps:
        todo = list(ps.children.get(i, ()))
        while todo:
            j = todo.pop()
            if ps.items[j].name == SPAN and ps.items[j].end_ns is not None:
                total += ps.ms(j)
                found += 1
            todo.extend(ps.children.get(j, ()))
    return total / len(steps) if found else None
