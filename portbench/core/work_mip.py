"""The yardstick's arithmetic for mip-NeRF (configuration ``mipnerf-lego``):
its MLP's multiply-adds a point and the points a training step evaluates.

The network is the NeRF MLP's layers (core/work.py ``layer_shapes``) on
mip-NeRF's encodings: the points' integrated positional encoding, six
columns a degree and no identity (96 at degrees [0, 16)), and the
directions' encoding with identity (27 at degree 4). A step evaluates
N_rand x N_samples coarse intervals and as many fine ones: the fine pass
resamples its own intervals and does not evaluate the coarse ones again.
"""

from __future__ import annotations

from portbench.core import work


def widths(net: dict) -> tuple:
    """(point encoding, direction encoding) columns."""
    return (6 * (net["max_deg_point"] - net["min_deg_point"]), 3 + 6 * net["deg_view"])


def layer_shapes(net: dict):
    return work.layer_shapes(net["depth"], net["width"], (4,), *widths(net))


def macs_per_point(net: dict) -> int:
    """Multiply-adds of one point through the MLP."""
    return sum(i * o for _, i, o in layer_shapes(net))


def weight_bytes(net: dict) -> int:
    """fp32 bytes of every weight and bias."""
    return 4 * sum(i * o + o for _, i, o in layer_shapes(net))


def points_per_ray(scene: dict) -> tuple:
    """(coarse, fine) intervals a ray."""
    return scene["N_samples"], scene["N_importance"]


def step_points(scene: dict) -> int:
    """Points a training step evaluates, both passes."""
    return scene["N_rand"] * sum(points_per_ray(scene))


def model_flops(net: dict, points: int) -> float:
    """FLOPs of ``points`` through a training step: 2 a multiply-add, three
    times the forward (forward, input and weight gradients)."""
    return 2.0 * macs_per_point(net) * points * 3
