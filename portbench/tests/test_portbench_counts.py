"""The yardstick's counts against hand counts, and the busy-share
arithmetic on overlapping intervals."""

import importlib.util

import pytest

from portbench.core import inputs, work
from portbench.core.cell import BENCH_DIR, load_cell
from portbench.core.trace import gaps, union_seconds

LEGO = {"depth": 8, "width": 256, "skips": (4,), "multires": 10, "multires_views": 4}


def _metric(name):
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"),
                                                  BENCH_DIR / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_macs_per_point_at_lego_width():
    # 63*256 + 4*256*256 + 319*256 + 2*256*256 + 256 + 256*256 + 283*128 + 128*3
    assert work.macs_per_point(LEGO) == 593_408
    assert 2 * work.macs_per_point(LEGO) == 1_186_816


@pytest.mark.parametrize("cell,points,tflop", [("lego-train", 262_144, 0.933),
                                               ("fern-train", 196_608, 0.700)])
def test_training_step_flops(cell, points, tflop):
    scene = inputs.scene_of(load_cell(cell).config)
    assert work.step_points(scene) == points
    flops = work.model_flops(LEGO, points, train=True)
    assert flops == 3 * 1_186_816 * points
    assert abs(flops / 1e12 - tflop) < 5e-4


@pytest.mark.parametrize("cell,points,tflop", [("lego-render", 160_000 * 256, 48.6),
                                               ("fern-render", 190_512 * 192, 43.4)])
def test_frame_flops(cell, points, tflop):
    scene = inputs.scene_of(load_cell(cell).config)
    assert work.frame_points(scene) == points
    assert abs(work.model_flops(LEGO, points, train=False) / 1e12 - tflop) < 0.05


def test_b5_bytes_at_32768_by_192():
    # raw 16 + z 4 + weight 4 bytes a sample, direction 12 in and 6 maps out a ray
    assert _metric("b5_roofline").bytes_moved(32_768, 192) == \
        32_768 * 192 * 24 + 32_768 * 36 == 152_174_592


def test_b2_counts_the_gradients_the_step_needs():
    # every dW, and dh of every layer but the encoded points' (first layer,
    # the skip's 63 columns) and the encoded directions' (27 x 128)
    b2 = _metric("b2_roofline")
    assert b2.macs_per_point(LEGO) == 593_408 + 593_408 - 63 * 256 - 63 * 256 - 27 * 128


def test_least_time_is_the_larger_bound():
    assert work.least_seconds(495e12, 0.0, "fp32") == 1.0
    assert work.least_seconds(0.0, 3.35e12, "fp32") == 1.0
    assert work.least_seconds(989e12, 3.35e11, "bf16") == 1.0


def test_busy_is_the_union_not_the_sum():
    iv = [(0, 10), (5, 15), (20, 25), (21, 22)]
    assert union_seconds(iv) == 20 / 1e9
    assert sum(e - s for s, e in iv) == 26
    assert gaps(iv, 0, 30) == [(15, 20), (25, 30)]
    assert gaps([(5, 8)], 0, 10) == [(0, 5), (8, 10)]
    assert union_seconds([]) == 0.0
