"""b1_ipe_roofline: kernel B1's IPE instantiation (``ops/cuda/fused_mlp.py``
``launch_points`` under mip-NeRF, ``nerf_points_ipe_kernel``), the
training step's forward of both passes, as the least time its work needs
over its device time in the traced window, as ``b1_roofline`` reads B1.
Counted by the program's ``B1 ipe`` launch counter. Moves
``train_rays_per_s``."""

from portbench.core import work, work_mip

KERNEL = "nerf_points_ipe_kernel"
COUNTER = "B1 ipe"


def flops(net: dict, points: int) -> float:
    """The forward's multiply-adds, two FLOPs each."""
    return 2.0 * work_mip.macs_per_point(net) * points


def bytes_moved(net: dict, rays: int, samples: int) -> int:
    """One launch of ``rays`` x ``samples`` points: the Gaussians (24 bytes
    a point), the view directions (12 a ray) and the weights read once, raw
    (4 floats a point) written once."""
    points = rays * samples
    return points * (24 + 16) + rays * 12 + work_mip.weight_bytes(net)


def step_least_seconds(scene: dict, net: dict) -> float:
    n = scene["N_rand"]
    return sum(work.least_seconds(flops(net, n * s), bytes_moved(net, n, s), "fp32")
               for s in work_mip.points_per_ray(scene))


def read(r):
    if r.kind != "train_mip":
        return None
    seconds = r.counted(COUNTER, KERNEL)
    if not seconds:
        return None
    return 100.0 * step_least_seconds(r.scene, r.net) * r.units / seconds
