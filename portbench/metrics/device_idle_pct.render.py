"""device_idle_pct.render: the share of the traced serving window in which
no operation ran on the card (the window less the union of the device
operations' intervals). Moves ``frame_ms``."""


def read(r):
    if r.kind != "serve" or r.window is None or r.window.seconds <= 0:
        return None
    return 100.0 * (1.0 - r.window.busy_seconds() / r.window.seconds)
