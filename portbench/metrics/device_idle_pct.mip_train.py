"""device_idle_pct.mip_train: ``device_idle_pct.train`` for mip-NeRF's
training step (traffic kind ``train_mip``): the share of the traced window
in which no operation ran on the card (the window less the union of the
device operations' intervals). Moves ``train_rays_per_s``."""


def read(r):
    if r.kind != "train_mip" or r.window is None or r.window.seconds <= 0:
        return None
    return 100.0 * (1.0 - r.window.busy_seconds() / r.window.seconds)
