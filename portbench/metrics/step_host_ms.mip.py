"""step_host_ms.mip: ``step_host_ms`` for mip-NeRF's training step (traffic
kind ``train_mip``): the mean host time, in ms, for a ``train_step`` call
to return (the benchmark's span around each call, no sync inside). Moves
``train_rays_per_s`` while the step is host-bound."""

import statistics


def read(r):
    ms = r.host.get("step_ms") if r.kind == "train_mip" else None
    return statistics.fmean(ms) if ms else None
