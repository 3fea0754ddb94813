"""Fixtures of the benchmark's tests: cells cut to a size the CPU runs in
seconds, and the card marker (a test that needs the card skips without
one, decided inside the fixture)."""

import copy

import pytest

from portbench.core.cell import load_cell

# every width and count the CPU tests shrink, per configuration key
TINY_FLAGS = {"netwidth": 32, "netwidth_fine": 32, "N_rand": 64, "N_samples": 8,
              "N_importance": 8, "chunk": 512}
TINY_DATASET = {"H": 24, "W": 32, "n_views": 10}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (runs on the chip only)")


def tiny(cell):
    """``cell`` with its configuration cut to a CPU test's size (the
    blender focal follows the image width as the loader's does)."""
    cell = copy.deepcopy(cell)
    cell.config["flags"].update(TINY_FLAGS)
    ds = cell.config["dataset"]
    ds.update(TINY_DATASET)
    if ds["kind"] == "llff":
        ds["focal"] = 1.2 * ds["W"]
        ds["render_path_views"] = 8
    else:
        ds["render_path_views"] = 8
    return cell


@pytest.fixture
def tiny_cell():
    return lambda name: tiny(load_cell(name))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the benchmark's card tests run on the chip")
    return torch.device("cuda")
