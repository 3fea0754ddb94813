"""Faults planted in the measured program's timed path, to show that the
check of ``correct`` catches them (portbench/tests/test_portbench_faults.py
on the CPU, ``control.py --faults`` on the card).

Each fault is ``install(driver) -> undo``, run by the driver after its
set-up has built the program's objects and before the first checked step
or request (the drivers' ``faults={"setup": ...}`` hook).

- ``unchanged``: the training step returns its state unchanged (Adam's
  update is skipped);
- ``half_batch``: the training loss is the mean over half of the rays,
  the rest left out;
- ``altered``: an answer altered where it is produced: the first ray's
  rendered colour in each training step moved by 0.5, or each served
  frame moved by 0.01;
- ``half_frame``: a served frame's lower half left out, filled with the
  mean colour of the rest.

A single-card cell has no exchange between cards to leave out.
"""

from __future__ import annotations

from typing import Callable, Dict


def _unchanged(driver) -> Callable:
    driver.state.apply_gradients = lambda: None
    return lambda: None


def _half_batch(driver) -> Callable:
    from nerf_shared_tpu_torch.train import step

    orig = step.img2mse

    def half(x, y):
        n = x.shape[0] // 2
        return orig(x[:n], y[:n])

    step.img2mse = half

    def undo():
        step.img2mse = orig
    return undo


def _altered_train(driver) -> Callable:
    from nerf_shared_tpu_torch.train import step

    orig = step.render_rays

    def altered(*a, **kw):
        ret = orig(*a, **kw)
        bump = ret["rgb_map"].new_zeros(ret["rgb_map"].shape)
        bump[0] = 0.5
        ret["rgb_map"] = ret["rgb_map"] + bump
        return ret

    step.render_rays = altered

    def undo():
        step.render_rays = orig
    return undo


def _frame_fault(driver, edit) -> Callable:
    engine = driver.service.engine
    orig = engine.render_poses

    def faulty(*a, **kw):
        rgbs = orig(*a, **kw).copy()
        edit(rgbs)
        return rgbs

    engine.render_poses = faulty
    return lambda: None


def _altered_frame(driver) -> Callable:
    def edit(rgbs):
        rgbs += 0.01
    return _frame_fault(driver, edit)


def _half_frame(driver) -> Callable:
    def edit(rgbs):
        h = rgbs.shape[1] // 2
        rgbs[:, h:] = rgbs[:, :h].mean(axis=(1, 2), keepdims=True)
    return _frame_fault(driver, edit)


FAULTS: Dict[str, Dict[str, Callable]] = {
    "train": {"unchanged": _unchanged, "half_batch": _half_batch, "altered": _altered_train},
    "serve": {"altered": _altered_frame, "half_frame": _half_frame},
}


class Planted:
    """The drivers' ``faults`` argument for one fault; ``undo()`` after the
    run restores the program's modules."""

    def __init__(self, kind: str, name: str):
        self.install = FAULTS[kind][name]
        self.undo = lambda: None

    def as_hooks(self) -> dict:
        def setup(driver):
            self.undo = self.install(driver)
        return {"setup": setup}
