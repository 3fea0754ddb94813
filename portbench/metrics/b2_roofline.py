"""b2_roofline: kernel B2 (``ops/cuda/fused_mlp_bwd.py``: the tile kernel
``nerf_bwd_kernel``, ``nerf_dw_kernel`` and ``grad_reduce_kernel``, their
times summed; bf16: the ``_bf16`` instantiations), the training step's
backward of both networks, as the least time its work needs over its
device time in the traced window. Moves ``train_rays_per_s``.

The work is what the step needs: every weight gradient, and the input
gradients of every layer except those of the encoded points (the first
layer's input, the skip's point columns) and of the encoded view
directions, which nothing upstream takes. The forward that B2 reruns is
not counted."""

from portbench.core import work

KERNELS = {"fp32": ("nerf_bwd_kernel", "nerf_dw_kernel", "grad_reduce_kernel"),
           "bf16": ("nerf_bwd_bf16_kernel", "nerf_dw_bf16_kernel", "grad_reduce_kernel")}

COUNTERS = {"fp32": "B2", "bf16": "B2 bf16"}


def macs_per_point(net: dict) -> int:
    p, v = work.encoded(net["multires"]), work.encoded(net["multires_views"])
    dw = work.macs_per_point(net)
    unneeded = p * net["width"]                       # first layer's input
    unneeded += sum(p * net["width"] for s in net["skips"] if s + 1 < net["depth"])
    unneeded += v * (net["width"] // 2)               # the view layer's directions
    return dw + (dw - unneeded)


def flops(net: dict, points: int) -> float:
    return 2.0 * macs_per_point(net) * points


def bytes_moved(net: dict, rays: int, samples: int) -> int:
    """One launch: the points (12 bytes), raw's cotangent (16), the view
    directions (12 a ray) and the weights read once; the weight gradients
    written once."""
    points = rays * samples
    return points * (12 + 16) + rays * 12 + 2 * work.weight_bytes(net)


def step_least_seconds(scene: dict, net: dict, precision: str) -> float:
    n = scene["N_rand"]
    return sum(work.least_seconds(flops(net, n * s), bytes_moved(net, n, s), precision)
               for s in work.points_per_ray(scene))


def read(r):
    if r.kind != "train" or r.window is None:
        return None
    names = KERNELS[r.precision]
    if r.counted(COUNTERS[r.precision], names[0]) is None:
        return None
    seconds, _ = r.window.kernel_seconds(*names)
    return 100.0 * step_least_seconds(r.scene, r.net, r.precision) * r.units / seconds
