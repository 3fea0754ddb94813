"""Run one cell of the benchmark once, on the card.

    python portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell, its configuration, traffic mix,
limits and per-layer metrics are found by the names in ``BENCHMARK.json``
(portbench/core/cell.py). Prints the result as the last line of standard
output (portbench/core/runner.py); exits non-zero, printing no result,
when there is no card, when the measured program is not in the checkout,
or when JAX or the JAX package was loaded.
"""

import argparse
import os
import sys
import time
from pathlib import Path


def _process_age() -> float:
    """Seconds since this process started (0 where /proc is not there)."""
    try:
        with open(f"/proc/{os.getpid()}/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


AGE0, T0 = _process_age(), time.perf_counter_ns()
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    opts = p.parse_args(argv)
    from portbench.core import runner

    return runner.main(opts, lambda t_ns: AGE0 + (t_ns - T0) / 1e9)


if __name__ == "__main__":
    sys.exit(main())
