"""mfu.render: the model FLOPs of the frames served in the traced window
(the forward of every point of both passes: core/work.py) over the
window, over the card's peak for the configuration's precision. Moves
``frame_ms``."""

from portbench.core import work


def read(r):
    if r.kind != "serve" or r.window is None or r.units == 0:
        return None
    flops = work.model_flops(r.net, work.frame_points(r.scene) * r.units, train=False)
    return 100.0 * flops / r.window.seconds / work.PEAK_FLOPS[r.precision]
