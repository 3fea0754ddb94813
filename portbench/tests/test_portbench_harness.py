"""What keeps the benchmark honest and extendable: nothing under portbench/
imports JAX or the JAX package (top-level names compared whole), the
reference imports nothing of the measured program, every cell finds its
files by name, a run without a card fails, and each cell runs end to end
at a CPU test's size with its check passing."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.core import runner
from portbench.core.cell import BENCH_DIR, ROOT, load_cell, metric_readers

FORBIDDEN = {"jax", "jaxlib", "flax", "nerf_shared_tpu"}
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def _imports(path: Path) -> set:
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


def _sources():
    return sorted(BENCH_DIR.rglob("*.py"))


def test_nothing_imports_jax_or_the_jax_package():
    assert "nerf_shared_tpu_torch" not in FORBIDDEN  # whole names, not prefixes
    for path in _sources():
        found = _imports(path) & FORBIDDEN
        assert not found, f"{path.relative_to(ROOT)} imports {found}"


def test_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH_DIR / "reference").rglob("*.py")):
        names = _imports(path)
        assert not names & (FORBIDDEN | {"nerf_shared_tpu_torch", "portbench"}), path


def test_runs_read_nothing_of_the_jax_benchmarks():
    for path in _sources():
        text = path.read_text()
        assert not re.search(r"\bbench\.py\b|['\"]benchmarks/", text), path


def test_benchmark_json_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", CELLS)
def test_cell_finds_its_files_by_name(name):
    cell = load_cell(name)
    assert cell.config["name"] == {w["name"]: w for w in BENCH["workloads"]}[name]["config"]
    assert (BENCH_DIR / "drivers" / f"{cell.traffic['kind']}.py").exists()
    assert set(cell.limits["limits"]) and all(v > 0 for v in cell.limits["limits"].values())
    readers = metric_readers(cell)
    assert readers and all(callable(r) for r in readers.values())
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2


def test_a_run_without_a_card_fails(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card path is for the CPU")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                          "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    # and in a checkout of the benchmark alone: no program to measure
    shutil.copytree(BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "{" not in out.stdout


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_end_to_end_at_a_cpu_size(name, tiny_cell):
    result = runner.run(tiny_cell(name), 2147483648 + 12, 0.5, False, lambda _: 0.0,
                        device="cpu")
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert set(result["metrics"]) == {m["name"] for m in load_cell(name).end_to_end}
    assert not runner.forbidden_modules()


@pytest.mark.card
def test_card_run_prints_a_result(card, tmp_path):
    """On the card: one short run of each kind, as the driver runs it."""
    for name in ("fern-train", "fern-render"):
        out = subprocess.run([sys.executable, "portbench/run.py", "--workload", name,
                              "--seed", "2147483777", "--seconds", "2", "--trace", "1"],
                             cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-2000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result["correct"] and result["device"]["busy_s"] > 0
