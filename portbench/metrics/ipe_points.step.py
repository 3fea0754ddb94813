"""ipe_points.step: the points a mip-NeRF training step sends through kernel
B1's IPE encoder, by the program's counter (``ops/cuda/fused_mlp.py``
``IPE_POINTS``) over the traced window's steps; B2's tile encodes them again
for its rerun forward, which the counter leaves out. Expected N_rand x
(N_samples + N_importance). Moves ``train_rays_per_s``."""

COUNTER = "ipe points"


def read(r):
    if r.kind != "train_mip" or r.units == 0:
        return None
    n = r.launches.get(COUNTER)
    return n / r.units if n else None
