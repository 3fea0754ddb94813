"""The check of ``correct`` against faults planted in the timed path: each
cell's run, past the harness's look for a card and at a CPU test's size,
comes out correct as it is and not correct with each fault the cell can
have (portbench/faults.py; a single-card cell has no exchange between
cards to leave out). On the card, ``test_control_fails_on_the_card`` holds
the controls (the reference in TF32, the program's bf16 route) to the
committed limits at the cells' own sizes."""

import json

import pytest

from portbench import control
from portbench.core import runner
from portbench.core.cell import load_cell
from portbench.faults import FAULTS, Planted

CASES = [(cell, fault) for cell, kind in (("lego-train", "train"), ("fern-train", "train"),
                                          ("lego-render", "serve"), ("fern-render", "serve"))
         for fault in FAULTS[kind]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_makes_the_run_incorrect(cell, fault, tiny_cell):
    c = tiny_cell(cell)
    planted = Planted(c.traffic["kind"], fault)
    try:
        result = runner.run(c, 2147483648 + 21, 0.5, False, lambda _: 0.0, device="cpu",
                            faults=planted.as_hooks())
    finally:
        planted.undo()
    assert not result["correct"], result["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["fern-train", "fern-render"])
def test_control_fails_on_the_card(cell, card, capsys):
    """One seed of the program passes and one of each control fails, at the
    cell's own size (the full readings: control.py, a dozen seeds)."""
    assert control.main(["--workload", cell, "--seeds", "1", "--control-seeds", "1",
                         "--seconds", "3", "--first-seed", "2147480000"]) == 0
    runs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith('{"run"')]
    assert [r["correct"] for r in runs] == [True, False, False]
    assert load_cell(cell).limits
