"""A cell of ``BENCHMARK.json`` and the files the harness finds by its
names: the configuration (``configs/<config>.json``, named by the
configuration's ``file``), the traffic mix (``traffic/<traffic>.json``),
the cell's correctness limits (``limits/<workload>.json``) and one reader
a per-layer metric (``metrics/<metric>.py``). Adding a cell or a metric
adds files and entries; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, workload: str, reported=None) -> bool:
    """A metric with ``workloads`` applies to those cells; an end-to-end
    metric without it to every cell, a per-layer one without it to every
    cell that reports the end-to-end metric it moves (``reported``)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return reported is None or metric["moves"] in reported


def load_cell(workload: str, bench_file: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell named ``workload`` with its files; raises KeyError naming
    the cells there are when there is none of that name."""
    bench = json.loads(Path(bench_file).read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_file.name}: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((BENCH_DIR / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload, reported)]
    return Cell(workload, int(w["chips"]), config, traffic, limits, e2e, per_layer)


def metric_reader(name: str) -> Callable:
    """``read`` of ``metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metric_readers(cell: Cell) -> Dict[str, Callable]:
    return {m["name"]: metric_reader(m["name"]) for m in cell.per_layer}
