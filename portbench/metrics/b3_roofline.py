"""b3_roofline: kernel B3 (``ops/cuda/fused_mlp.py``
``fused_nerf_forward_rays``, ``nerf_rays_tc_kernel``; bf16:
``nerf_rays_bf16_kernel``), the dense frame's network on both passes, as
the least time its work needs over its device time in the traced window.
Moves ``frame_ms``."""

from portbench.core import work

KERNELS = {"fp32": "nerf_rays_tc_kernel", "bf16": "nerf_rays_bf16_kernel"}

COUNTERS = {"fp32": "B3", "bf16": "B3 bf16"}


def flops(net: dict, points: int) -> float:
    return 2.0 * work.macs_per_point(net) * points


def bytes_moved(net: dict, rays: int, samples: int) -> int:
    """One launch: each ray's origin, direction and view direction (36
    bytes), each sample's depth (4) and the weights read once; raw (16 a
    sample) written once."""
    return rays * 36 + rays * samples * (4 + 16) + work.weight_bytes(net)


def frame_least_seconds(scene: dict, net: dict, precision: str, chunk: int) -> float:
    """Both passes of every block of ``chunk`` rays of a frame."""
    total, rays = 0.0, work.frame_rays(scene)
    for at in range(0, rays, chunk):
        n = min(chunk, rays - at)
        total += sum(work.least_seconds(flops(net, n * s), bytes_moved(net, n, s), precision)
                     for s in work.points_per_ray(scene))
    return total


def read(r):
    if r.kind != "serve":
        return None
    seconds = r.counted(COUNTERS[r.precision], KERNELS[r.precision])
    if not seconds:
        return None
    least = frame_least_seconds(r.scene, r.net, r.precision, r.scene["chunk"])
    return 100.0 * least * r.units / seconds
