"""device_idle_pct.train: the share of the traced training window in which
no operation ran on the card (the window less the union of the device
operations' intervals, so overlapping operations count once). Moves
``train_rays_per_s``."""


def read(r):
    if r.kind != "train" or r.window is None or r.window.seconds <= 0:
        return None
    return 100.0 * (1.0 - r.window.busy_seconds() / r.window.seconds)
