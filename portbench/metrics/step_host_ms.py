"""step_host_ms: the mean host time, in ms, for a ``train_step`` call to
return (the benchmark's span around each call, no sync inside): the pixel
draw, the rays, the kernels' wrappers and launches, autograd and Adam.
Moves ``train_rays_per_s`` while the step is host-bound."""

import statistics


def read(r):
    ms = r.host.get("step_ms") if r.kind == "train" else None
    return statistics.fmean(ms) if ms else None
