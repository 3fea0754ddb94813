"""mfu.mip_train: the model FLOPs of mip-NeRF's training steps completed in
the traced window (three times the forward of every interval of both
passes: core/work_mip.py) over the window, over TF32's 495 TFLOP/s (the
configuration is fp32). Moves ``train_rays_per_s``."""

from portbench.core import work, work_mip


def read(r):
    if r.kind != "train_mip" or r.window is None or r.units == 0:
        return None
    flops = work_mip.model_flops(r.net, work_mip.step_points(r.scene) * r.units)
    return 100.0 * flops / r.window.seconds / work.PEAK_FLOPS["fp32"]
