"""The readings that a cell's correctness limits are set from, on the card.

    python portbench/control.py --workload <name> --seeds 12 --control-seeds 3 \\
        [--faults half_batch,altered] [--seconds 2] [--first-seed N]

In one process (set-up once per seed, the imports and the card's start-up
once), every run through the cell's own set-up, sizes and check:

- ``program``: the program as the cell runs it, on ``--seeds`` seeds, with
  a window of ``--seconds`` (the lower readings);
- ``tf32``: the control the configuration's precision asks for, on
  ``--control-seeds`` seeds: the reference put in the program's place and
  computed with TF32 on (fp32 with TF32 off is the configuration's);
- ``bf16``: the program's own ``--precision bf16`` route, on
  ``--control-seeds`` seeds;
- ``fault:<name>``: each named fault of ``faults.py`` planted in the
  program, on ``--control-seeds`` seeds.

Prints one JSON line a run and a summary: each number's largest program
reading and its smallest reading under each control and fault.
"""

import argparse
import copy
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.core import runner  # noqa: E402
from portbench.core.cell import load_cell  # noqa: E402
from portbench.faults import Planted  # noqa: E402


def bf16_cell(cell):
    """The cell with the program switched to its bf16 route."""
    cell = copy.deepcopy(cell)
    cell.traffic["flags"] = {**cell.traffic.get("flags", {}), "precision": "bf16"}
    return cell


def tf32_control(cell, seed: int, device) -> dict:
    """The checks of the reference computed with TF32 on, put where the
    program's outputs go: its checked steps, or the frames of as many
    requests as a run checks."""
    import importlib

    import torch

    drv = importlib.import_module(f"portbench.drivers.{cell.traffic['kind']}").Driver(
        cell, seed, device)
    try:
        drv.setup()
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        if drv.kind == "train":
            drv.prog = drv.reference()
        else:
            drv.sent = [drv.next_pose() for _ in range(cell.traffic["checked_frames"])]
            drv.frames = [drv.reference(c2w)["rgb"].cpu().numpy() for c2w in drv.sent]
        drv.release()
        checks = drv.check()
    finally:
        drv.close()
    limits = cell.limits["limits"]
    return {"correct": all(checks[k] == checks[k] and checks[k] <= lim
                           for k, lim in limits.items()),
            "checks": {k: {"value": v, "limit": limits.get(k)} for k, v in checks.items()},
            "detail": getattr(drv, "detail", {})}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    o = p.parse_args(argv)
    cell = load_cell(o.workload)
    runs = [("program", cell, None, o.first_seed + i) for i in range(o.seeds)]
    runs += [("tf32", cell, None, o.first_seed + 100 + i) for i in range(o.control_seeds)]
    runs += [("bf16", bf16_cell(cell), None, o.first_seed + 100 + i)
             for i in range(o.control_seeds)]
    for name in filter(None, o.faults.split(",")):
        runs += [(f"fault:{name}", cell, name, o.first_seed + 200 + i)
                 for i in range(o.control_seeds)]
    readings = {}
    for label, c, fault, seed in runs:
        planted = Planted(c.traffic["kind"], fault) if fault else None
        t = time.perf_counter()
        try:
            if label == "tf32":
                r = tf32_control(c, seed, "cuda")
            else:
                r = runner.run(c, seed, o.seconds, False, lambda _: 0.0, device="cuda",
                               faults=planted.as_hooks() if planted else None)
        finally:
            if planted:
                planted.undo()
        checks = {k: v["value"] for k, v in r["checks"].items()}
        checks.update(r["detail"].get("not_compared", {}))
        print(json.dumps({"run": label, "seed": seed, "correct": r["correct"],
                          "checks": checks, "detail": r["detail"],
                          "s": round(time.perf_counter() - t, 1)}), flush=True)
        for k, v in checks.items():
            readings.setdefault(label, {}).setdefault(k, []).append(v)
    summary = {}
    for label, nums in readings.items():
        pick = max if label == "program" else min
        summary[label] = {k: pick(float("inf") if x is None else x for x in v)
                          for k, v in nums.items()}
    print(json.dumps({"workload": o.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
