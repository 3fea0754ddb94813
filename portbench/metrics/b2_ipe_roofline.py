"""b2_ipe_roofline: kernel B2's IPE instantiation (``ops/cuda/fused_mlp_bwd.py``
under mip-NeRF: the tile kernel ``nerf_bwd_ipe_kernel``, ``nerf_dw_kernel``
and ``grad_reduce_kernel``, their times summed), the training step's
backward of both passes, as the least time its work needs over its device
time in the traced window, as ``b2_roofline`` reads B2. Counted by the
program's ``B2 ipe`` launch counter. Moves ``train_rays_per_s``.

The work is what the step needs: every weight gradient, and the input
gradients of every layer except those of the encoded points (the first
layer's input, the skip's point columns) and of the encoded directions,
which nothing upstream takes. The rerun forward is not counted."""

from portbench.core import work, work_mip

KERNELS = ("nerf_bwd_ipe_kernel", "nerf_dw_kernel", "grad_reduce_kernel")
COUNTER = "B2 ipe"


def macs_per_point(net: dict) -> int:
    p, v = work_mip.widths(net)
    dw = work_mip.macs_per_point(net)
    unneeded = p * net["width"] * (2 if 5 < net["depth"] else 1)   # layer 0, the skip's
    unneeded += v * (net["width"] // 2)                              # the view layer's
    return dw + (dw - unneeded)


def flops(net: dict, points: int) -> float:
    return 2.0 * macs_per_point(net) * points


def bytes_moved(net: dict, rays: int, samples: int) -> int:
    """One launch: the Gaussians (24 bytes a point), raw's cotangent (16),
    the view directions (12 a ray) and the weights read once; the weight
    gradients written once."""
    points = rays * samples
    return points * (24 + 16) + rays * 12 + 2 * work_mip.weight_bytes(net)


def step_least_seconds(scene: dict, net: dict) -> float:
    n = scene["N_rand"]
    return sum(work.least_seconds(flops(net, n * s), bytes_moved(net, n, s), "fp32")
               for s in work_mip.points_per_ray(scene))


def read(r):
    if r.kind != "train_mip" or r.window is None:
        return None
    if r.counted(COUNTER, KERNELS[0]) is None:
        return None
    seconds, _ = r.window.kernel_seconds(*KERNELS)
    return 100.0 * step_least_seconds(r.scene, r.net) * r.units / seconds
