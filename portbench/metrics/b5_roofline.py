"""b5_roofline: kernel B5 (``ops/cuda/composite.py``, ``composite_kernel``),
the dense frame's alpha compositing of both passes, as the least time its
bytes need over its device time in the traced window. Moves ``frame_ms``.

B5 is bound by bytes: per sample it reads raw (4 floats) and the depth
and writes the compositing weight; per ray it reads the direction and
writes the six per-ray maps. Its FLOPs are not counted."""

from portbench.core import work


def bytes_moved(rays: int, samples: int) -> int:
    return rays * samples * (16 + 4 + 4) + rays * (12 + 24)


def frame_least_seconds(scene: dict) -> float:
    rays = work.frame_rays(scene)
    return sum(bytes_moved(rays, s) for s in work.points_per_ray(scene)) / work.PEAK_BYTES


def read(r):
    if r.kind != "serve":
        return None
    seconds = r.counted("B5", "composite_kernel")
    if not seconds:
        return None
    return 100.0 * frame_least_seconds(r.scene) * r.units / seconds
