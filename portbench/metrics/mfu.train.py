"""mfu.train: the model FLOPs of the training steps completed in the
traced window (three times the forward of every point, coarse and fine:
core/work.py) over the window, over the card's peak for the
configuration's precision (TF32's 495 TFLOP/s for fp32). Moves
``train_rays_per_s``."""

from portbench.core import work


def read(r):
    if r.kind != "train" or r.window is None or r.units == 0:
        return None
    flops = work.model_flops(r.net, work.step_points(r.scene) * r.units, train=True)
    return 100.0 * flops / r.window.seconds / work.PEAK_FLOPS[r.precision]
