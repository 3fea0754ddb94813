"""b1_roofline: kernel B1 (``ops/cuda/fused_mlp.py`` ``launch_points``,
``nerf_points_tc_kernel``; bf16: ``nerf_points_bf16_kernel``), the
training step's forward of both networks, as the least time its work
needs over its device time in the traced window. Moves
``train_rays_per_s``."""

from portbench.core import work

KERNELS = {"fp32": "nerf_points_tc_kernel", "bf16": "nerf_points_bf16_kernel"}

COUNTERS = {"fp32": "B1", "bf16": "B1 bf16"}


def flops(net: dict, points: int) -> float:
    """The forward's multiply-adds, two FLOPs each."""
    return 2.0 * work.macs_per_point(net) * points


def bytes_moved(net: dict, rays: int, samples: int) -> int:
    """One launch of ``rays`` x ``samples`` points: the points (12 bytes),
    the view directions (12 a ray) and the weights read once, raw (4
    floats a point) written once."""
    points = rays * samples
    return points * (12 + 16) + rays * 12 + work.weight_bytes(net)


def step_least_seconds(scene: dict, net: dict, precision: str) -> float:
    n = scene["N_rand"]
    return sum(work.least_seconds(flops(net, n * s), bytes_moved(net, n, s), precision)
               for s in work.points_per_ray(scene))


def read(r):
    if r.kind != "train":
        return None
    seconds = r.counted(COUNTERS[r.precision], KERNELS[r.precision])
    if not seconds:
        return None
    return 100.0 * step_least_seconds(r.scene, r.net, r.precision) * r.units / seconds
