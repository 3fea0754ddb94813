"""One run of one cell: set-up, the measured window, the check, and the
result line.

The result is the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit. The same numbers are the last lines of standard error.
"""

from __future__ import annotations

import importlib
import json
import math
import subprocess
import sys
from typing import Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "nerf_shared_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (``nerf_shared_tpu_torch`` is neither)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", "0"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def run(cell, seed: int, seconds: float, trace: bool, age_at, device="cuda",
        faults=None) -> dict:
    """Run ``cell`` (core/cell.py) once; ``age_at(t_ns)`` is the process's
    age in seconds at ``time.perf_counter_ns()`` reading ``t_ns``;
    ``faults`` (tests) plants faults in the driver. Returns the result
    object (without printing it)."""
    import torch

    from portbench.core.cell import metric_readers

    driver = importlib.import_module(f"portbench.drivers.{cell.traffic['kind']}").Driver(
        cell, seed, device, faults)
    readers = metric_readers(cell) if trace else {}
    dev = torch.device(device)
    try:
        driver.setup()
        out = driver.window(seconds, trace)
        setup_s = age_at(out["t0"])
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        driver.release()
        checks = driver.check()
    finally:
        driver.close()
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        from portbench.core.reading import Reading

        reading = Reading(driver.kind, driver.scene, driver.net, driver.precision,
                          out["units"], out["trace"], driver.spans, out["launches"],
                          driver.host)
        values = {}
        for name, read in readers.items():
            v = read(reading)
            if v is not None:
                values[name] = v
    else:
        values = {"setup_s": setup_s, **out["metrics"]}
    metrics = {k: {"value": _finite(v), "unit": units[k]} for k, v in values.items()
               if k in units}
    limits = cell.limits["limits"]
    compared = {k: {"value": _finite(checks[k]), "limit": lim} for k, lim in limits.items()}
    correct = (out["attempted"] > 0 and out["failed"] == 0
               and all(checks[k] == checks[k] and checks[k] <= lim for k, lim in limits.items()))
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if dev.type == "cuda":
        device_info["power_limit"] = power_limit()
    result = {"correct": bool(correct), "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_info}
    win = out["trace"]
    if trace and win is not None:
        from portbench.core.trace import breakdown

        device_info["busy_s"] = win.busy_seconds()
        device_info["window_s"] = win.seconds
        result["breakdown"] = breakdown(win, driver.spans, driver.span_labels())
    result["detail"] = {**getattr(driver, "detail", {}), "window_units": out["units"],
                        "launches": {k: v for k, v in out["launches"].items() if v},
                        "not_compared": {k: _finite(v) for k, v in checks.items()
                                         if k not in limits}}
    result["checks"] = compared
    return result


def main(opts, age_at) -> int:
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark measures the card and does not "
              "fall back to the CPU", file=sys.stderr)
        return 3
    from portbench.core.cell import load_cell

    cell = load_cell(opts.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {opts.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    try:
        import nerf_shared_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program nerf_shared_tpu_torch is not here ({e})",
              file=sys.stderr)
        return 4
    result = run(cell, opts.seed, opts.seconds, bool(opts.trace), age_at)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 5
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
