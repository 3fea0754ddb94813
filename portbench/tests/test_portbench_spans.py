"""The readers of the program's own spans (core/program_spans.py and the
``host_ms.*`` and ``syncs.*`` metrics) on a synthetic traced window: the
program's spans on the host's clock at a known offset, each reader
against a value worked out by hand; None with no spans, with dropped spans, and with a
program that records none."""

import pytest

from nerf_shared_tpu_torch.utils import profiling
from nerf_shared_tpu_torch.utils.profiling import Recorded, Span
from portbench.core.cell import metric_reader
from portbench.core.reading import Reading
from portbench.core.trace import Spans, Window

OFF = 10_000  # device clock = host clock + OFF
WIN = Window(ops=[], start=100_000, end=200_000, host_offset=OFF)  # host [90_000, 190_000]


def _spans(rows):
    """Span list from (name, start, end, parent, unit, syncs) rows."""
    return [Span(*row) for row in rows]


# two steps inside the window, one before it and one that ends after it
TRAIN = _spans([
    ("train_step", 80_000, 89_000, -1, 0, 5),            # 0: before the window
    ("train_step", 91_000, 131_000, -1, 1, 0),           # 1
    ("train_step.draw", 91_000, 101_000, 1, 1, 1),       # 2
    ("train_step.forward", 101_000, 111_000, 1, 1, 0),   # 3
    ("train_step.backward", 111_000, 121_000, 1, 1, 2),  # 4
    ("train_step.adam", 121_000, 131_000, 1, 1, 0),      # 5
    ("train_step", 131_000, 171_000, -1, 2, 0),          # 6
    ("train_step.draw", 131_000, 135_000, 6, 2, 0),      # 7
    ("train_step.forward", 135_000, 151_000, 6, 2, 0),   # 8
    ("train_step.backward", 151_000, 163_000, 6, 2, 1),  # 9
    ("train_step.adam", 163_000, 171_000, 6, 2, 0),      # 10
    ("train_step", 185_000, 195_000, -1, 3, 7),          # 11: ends after the window
    ("train_step.draw", 185_000, 195_000, 11, 3, 0),     # 12
])
OPS = [("k", 101_500, 190_000)]

SERVE = _spans([
    ("request", 92_000, 140_000, -1, 1, 0),              # 0
    ("frame", 94_000, 129_000, 0, 1, 0),                 # 1
    ("frame.copy", 110_000, 129_000, 1, 1, 1),           # 2
    ("request.encode", 130_000, 139_000, 0, 1, 0),       # 3
    ("request", 140_000, 180_000, -1, 2, 0),             # 4
    ("frame", 141_000, 169_000, 4, 2, 0),                # 5
    ("frame.copy", 160_000, 169_000, 5, 2, 2),           # 6
    ("request.encode", 170_000, 175_000, 4, 2, 1),       # 7
    ("request", 185_000, 195_000, -1, 3, 9),             # 8: ends after the window
    ("request.encode", 186_000, 194_000, 8, 3, 0),       # 9
])


def _reading(kind, ops, window=True):
    win = Window(ops, WIN.start, WIN.end, WIN.host_offset) if window else None
    return Reading(kind, {}, {}, "fp32", 2, win, Spans(), {}, {})


@pytest.fixture
def recorded(monkeypatch):
    def use(items, dropped=0):
        monkeypatch.setattr(profiling, "spans", lambda: Recorded(items, dropped))
    return use


@pytest.mark.parametrize("name,want", [
    ("host_ms.draw", (10_000 + 4_000) / 2 / 1e6),
    ("host_ms.forward", (10_000 + 16_000) / 2 / 1e6),
    ("host_ms.backward", (10_000 + 12_000) / 2 / 1e6),
    ("host_ms.adam", (10_000 + 8_000) / 2 / 1e6),
    ("syncs.step", (1 + 2 + 1) / 2),
])
def test_training_readers(recorded, name, want):
    recorded(TRAIN)
    assert metric_reader(name)(_reading("train", OPS)) == pytest.approx(want)
    # a serving window has no steps
    assert metric_reader(name)(_reading("serve", OPS)) is None


@pytest.mark.parametrize("name,want", [
    ("host_ms.engine", ((35_000 - 19_000) + (28_000 - 9_000)) / 2 / 1e6),
    ("host_ms.encode", (9_000 + 5_000) / 2 / 1e6),
    ("syncs.frame", (1 + 3) / 2),
])
def test_serving_readers(recorded, name, want):
    recorded(SERVE)
    assert metric_reader(name)(_reading("serve", OPS)) == pytest.approx(want)
    assert metric_reader(name)(_reading("train", [])) is None


NEW = ["host_ms.draw", "host_ms.forward", "host_ms.backward", "host_ms.adam",
       "syncs.step", "host_ms.engine", "host_ms.encode", "syncs.frame"]


@pytest.mark.parametrize("name", NEW)
def test_readers_find_nothing_to_read(recorded, monkeypatch, name):
    kind = "train" if name in NEW[:5] else "serve"
    spans = TRAIN if kind == "train" else SERVE
    read = metric_reader(name)
    recorded([])
    assert read(_reading(kind, OPS)) is None
    recorded(spans, dropped=1)
    assert read(_reading(kind, OPS)) is None
    recorded(spans)
    assert read(_reading(kind, OPS, window=False)) is None
    # a program whose profiling module records no spans (the parent's)
    monkeypatch.delattr(profiling, "spans")
    assert read(_reading(kind, OPS)) is None
