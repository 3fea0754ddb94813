"""The mip-NeRF cell (``mip-lego-train``): its readers' FLOP and byte
counts against hand counts, the readers' silence on a program without the
IPE kernels, and the ``train_mip`` driver's set-up and check at a CPU
test's size, correct as it is and not correct with each fault planted."""

import importlib.util

import pytest

from portbench.core import inputs, runner, work_mip
from portbench.core.cell import BENCH_DIR, load_cell
from portbench.core.reading import Reading
from portbench.core.trace import Spans, Window
from portbench.drivers import train_mip
from portbench.faults import Planted

MIP = {"depth": 8, "width": 256, "min_deg_point": 0, "max_deg_point": 16, "deg_view": 4}


def _metric(name):
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"),
                                                  BENCH_DIR / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_macs_per_point_at_mip_width():
    # 96*256 + 4*256*256 + 352*256 + 2*256*256 + 256 + 256*256 + 283*128 + 128*3
    assert work_mip.widths(MIP) == (96, 27)
    assert work_mip.macs_per_point(MIP) == 610_304
    assert train_mip.net_of(load_cell("mip-lego-train").config)["max_deg_point"] == 16


def test_recipe_is_the_programs_constants():
    """The configuration's ``recipe`` (what the reference trains with) is
    what the program holds as mip-NeRF's constants."""
    from nerf_shared_tpu_torch.models.nerf import MipNeRFConfig as C
    from nerf_shared_tpu_torch.train.state import MipSchedule as S

    assert load_cell("mip-lego-train").config["recipe"] == {
        "lr_final": S.lr_final, "max_steps": S.max_steps, "lr_delay_steps": S.delay_steps,
        "lr_delay_mult": S.delay_mult, "min_deg_point": C.min_deg_point,
        "max_deg_point": C.multires, "deg_view": C.multires_views,
        "density_bias": C.density_bias, "rgb_padding": C.rgb_padding,
        "resample_padding": C.resample_padding, "coarse_loss_mult": C.coarse_loss_mult}


def test_training_step_points_and_flops():
    scene = inputs.scene_of(load_cell("mip-lego-train").config)
    assert work_mip.step_points(scene) == 4096 * 256 == 1_048_576
    flops = work_mip.model_flops(MIP, 1_048_576)
    assert flops == 3 * 2 * 610_304 * 1_048_576
    assert abs(flops / 1e12 - 3.840) < 5e-4


def test_b1_ipe_bytes_and_flops():
    b1 = _metric("b1_ipe_roofline")
    # Gaussians 24 + raw 16 bytes a point, a direction 12 a ray, the weights once
    assert b1.bytes_moved(MIP, 4096, 128) == 4096 * 128 * 40 + 4096 * 12 + \
        work_mip.weight_bytes(MIP)
    assert b1.flops(MIP, 1) == 2 * 610_304


def test_b2_ipe_counts_the_gradients_the_step_needs():
    # every dW, and dh of every layer but the IPE's (first layer, the
    # skip's 96 columns) and the directions' (27 x 128)
    b2 = _metric("b2_ipe_roofline")
    assert b2.macs_per_point(MIP) == 610_304 + 610_304 - 96 * 256 - 96 * 256 - 27 * 128
    assert b2.bytes_moved(MIP, 4096, 128) == 4096 * 128 * 40 + 4096 * 12 + \
        2 * work_mip.weight_bytes(MIP)


def _reading(launches, window=None, units=10):
    scene = inputs.scene_of(load_cell("mip-lego-train").config)
    return Reading("train_mip", scene, MIP, "fp32", units, window, Spans(), launches, {})


def test_readers_say_nothing_without_the_ipe_kernels():
    """A program without the IPE instantiations (the parent) counts none:
    each reader returns None and raises nothing."""
    win = Window([("nstt::tc::nerf_points_tc_kernel(...)", 0, 10)], 0, 100, 0)
    r = _reading({"B1": 1, "B1 ipe": 0, "B2 ipe": 0, "ipe points": 0}, win)
    for name in ("b1_ipe_roofline", "b2_ipe_roofline", "ipe_points.step", "host_ms.gauss"):
        assert _metric(name).read(r) is None, name
    assert _metric("mfu.mip_train").read(_reading({}, None)) is None


STEP_READERS = ("device_idle_pct.mip_train", "step_host_ms.mip", "syncs.mip_step",
                "host_ms.mip_draw", "host_ms.mip_forward", "host_ms.mip_backward",
                "host_ms.mip_adam")


def test_step_readers_read_the_mip_kind_alone():
    """The step-level readers of kind ``train_mip`` read its window and
    host times, and say nothing of another kind's run or of a run whose
    program recorded no spans."""
    import dataclasses

    win = Window([("nstt::tc::nerf_points_ipe_kernel(...)", 0, 75)], 0, 100, 0)
    r = _reading({}, win)
    r.host["step_ms"] = [4.0, 6.0]
    assert abs(_metric("device_idle_pct.mip_train").read(r) - 25.0) < 1e-9
    assert _metric("step_host_ms.mip").read(r) == 5.0
    for name in STEP_READERS[2:]:
        assert _metric(name).read(r) is None, name
    other = dataclasses.replace(r, kind="train")
    for name in STEP_READERS:
        assert _metric(name).read(other) is None, name


def test_ipe_points_and_mfu_read_the_counters_and_the_window():
    win = Window([("nstt::tc::nerf_points_ipe_kernel(...)", 0, 10)], 0, 10**9, 0)
    r = _reading({"B1 ipe": 20, "ipe points": 10 * 1_048_576}, win)
    assert _metric("ipe_points.step").read(r) == 1_048_576
    mfu = _metric("mfu.mip_train").read(r)
    assert abs(mfu - 100 * 10 * 3 * 2 * 610_304 * 1_048_576 / 495e12) < 1e-9
    # one traced launch where the counter says 20: unreported
    assert _metric("b1_ipe_roofline").read(r) is None


@pytest.mark.parametrize("fault", [None, "unattenuated", "unchanged", "half_batch", "altered"])
def test_driver_checks_at_a_cpu_size(fault, tiny_cell):
    cell = tiny_cell("mip-lego-train")
    assert cell.traffic["kind"] == "train_mip"
    hooks, undo = None, None
    if fault == "unattenuated":
        box = {}
        hooks = {"setup": lambda drv: box.setdefault("undo", train_mip.FAULTS[fault](drv))}
        undo = lambda: box.get("undo", lambda: None)()  # noqa: E731
    elif fault is not None:
        planted = Planted("train", fault)
        hooks, undo = planted.as_hooks(), lambda: planted.undo()
    try:
        result = runner.run(cell, 2147483648 + 31, 0.5, False, lambda _: 0.0, device="cpu",
                            faults=hooks)
    finally:
        if undo is not None:
            undo()
    assert result["correct"] == (fault is None), result["checks"]
    if fault is None:
        assert result["attempted"] > 0 and "train_rays_per_s" in result["metrics"]
