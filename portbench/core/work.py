"""The yardstick's arithmetic: the NeRF MLP's multiply-adds a point, the
points a training step or a frame evaluates, and the card's published
peaks.

The work is the algorithm's for these inputs, whatever implements it: one
multiply-add per weight a point (the encoder's sin and cos and the bias
adds are not counted), each layer once.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: the fastest unit that takes each
# configuration's operands (TF32 for fp32 operands: no fp32-accurate
# implementation can run faster), and HBM3's bandwidth
PEAK_FLOPS = {"fp32": 495e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12


def layer_shapes(depth: int, width: int, skips, enc_pts: int, enc_views: int):
    """[(name, fan_in, fan_out)] of the viewdir NeRF MLP."""
    out = []
    for i in range(depth):
        fan_in = enc_pts if i == 0 else (width + enc_pts if (i - 1) in skips else width)
        out.append((f"pts_linears.{i}", fan_in, width))
    out += [("alpha_linear", width, 1), ("feature_linear", width, width),
            ("views_linears.0", width + enc_views, width // 2),
            ("rgb_linear", width // 2, 3)]
    return out


def encoded(n_freqs: int) -> int:
    return 3 + 6 * n_freqs


def macs_per_point(net: dict) -> int:
    """Multiply-adds of one point through the MLP."""
    return sum(i * o for _, i, o in layer_shapes(
        net["depth"], net["width"], net["skips"], encoded(net["multires"]),
        encoded(net["multires_views"])))


def weight_bytes(net: dict) -> int:
    """fp32 bytes of every weight and bias."""
    return 4 * sum(i * o + o for _, i, o in layer_shapes(
        net["depth"], net["width"], net["skips"], encoded(net["multires"]),
        encoded(net["multires_views"])))


def points_per_ray(scene: dict) -> tuple:
    """(coarse, fine) samples a ray: the fine pass evaluates the coarse
    depths and the inverse-CDF ones together."""
    return scene["N_samples"], scene["N_samples"] + scene["N_importance"]


def step_points(scene: dict) -> int:
    """Points a training step evaluates, both passes."""
    return scene["N_rand"] * sum(points_per_ray(scene))


def frame_rays(scene: dict) -> int:
    return scene["H"] * scene["W"]


def frame_points(scene: dict) -> int:
    """Points a dense frame evaluates, both passes."""
    return frame_rays(scene) * sum(points_per_ray(scene))


def model_flops(net: dict, points: int, train: bool) -> float:
    """FLOPs of ``points`` through the MLP: 2 a multiply-add, and three
    times the forward in a training step (forward, input and weight
    gradients)."""
    return 2.0 * macs_per_point(net) * points * (3 if train else 1)


def least_seconds(flops: float, nbytes: float, precision: str) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS[precision], nbytes / PEAK_BYTES)
