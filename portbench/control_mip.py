"""The readings that ``mip-lego-train``'s correctness limits are set from,
on the card: ``control.py`` for the traffic kind ``train_mip``.

    python portbench/control_mip.py --seeds 6 --control-seeds 3 \\
        [--faults unattenuated,half_batch,altered,unchanged] [--seconds 2] [--first-seed N]

In one process, every run through the cell's own set-up, sizes, check and
limits (``Driver.check()`` and ``limits/<workload>.json``):

- ``program``: the program as the cell runs it, on ``--seeds`` seeds, with
  a window of ``--seconds`` (the lower readings);
- ``tf32``: the reference put in the program's place and computed with
  TF32 on (the configuration's precision is fp32 with TF32 off), on
  ``--control-seeds`` seeds: it has to come out not correct;
- ``fault:<name>``: a fault planted in the program, on ``--control-seeds``
  seeds: ``unattenuated`` (drivers/train_mip.py ``FAULTS``: the IPE
  without its variances) or one of faults.py's training faults.

mip-NeRF runs in fp32 alone, so there is no bf16 route to read. Prints one
JSON line a run and a summary: each number's largest program reading and
its smallest reading under the control and each fault.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.core import runner  # noqa: E402
from portbench.core.cell import load_cell  # noqa: E402
from portbench.faults import Planted  # noqa: E402


def tf32_control_mip(cell, seed: int, device) -> dict:
    """The checked steps of the reference computed with TF32 on, put where
    the program's go, through the driver's check and the cell's limits."""
    import torch

    from portbench.drivers.train_mip import Driver

    drv = Driver(cell, seed, device)
    try:
        drv.setup()
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            drv.prog = drv.reference()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        drv.release()
        checks = drv.check()
    finally:
        drv.close()
    limits = cell.limits["limits"]
    return {"correct": all(checks[k] == checks[k] and checks[k] <= lim
                           for k, lim in limits.items()),
            "checks": {k: {"value": v, "limit": limits.get(k)} for k, v in checks.items()},
            "detail": getattr(drv, "detail", {})}


def fault_hooks(name: str):
    """(hooks, undo) of a fault: ``unattenuated`` from the cell's driver,
    the others from faults.py's training faults."""
    from portbench.drivers import train_mip

    if name in train_mip.FAULTS:
        box = {}
        hooks = {"setup": lambda drv: box.setdefault("undo", train_mip.FAULTS[name](drv))}
        return hooks, lambda: box.get("undo", lambda: None)()
    planted = Planted("train", name)
    return planted.as_hooks(), lambda: planted.undo()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="mip-lego-train")
    p.add_argument("--seeds", type=int, default=6)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--faults", default="unattenuated")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    p.add_argument("--device", default="cuda")
    o = p.parse_args(argv)
    cell = load_cell(o.workload)
    if cell.traffic["kind"] != "train_mip":
        raise SystemExit(f"{o.workload} is of kind {cell.traffic['kind']}: use control.py")
    runs = [("program", None, o.first_seed + i) for i in range(o.seeds)]
    runs += [("tf32", None, o.first_seed + 100 + i) for i in range(o.control_seeds)]
    for name in filter(None, o.faults.split(",")):
        runs += [(f"fault:{name}", name, o.first_seed + 200 + i)
                 for i in range(o.control_seeds)]
    readings, correct = {}, {}
    for label, fault, seed in runs:
        t = time.perf_counter()
        if label == "tf32":
            r = tf32_control_mip(cell, seed, o.device)
        else:
            hooks, undo = fault_hooks(fault) if fault else (None, lambda: None)
            try:
                r = runner.run(cell, seed, o.seconds, False, lambda _: 0.0, device=o.device,
                               faults=hooks)
            finally:
                undo()
        checks = {k: v["value"] for k, v in r["checks"].items()}
        checks.update(r["detail"].get("not_compared", {}))
        print(json.dumps({"run": label, "seed": seed, "correct": r["correct"],
                          "checks": checks, "s": round(time.perf_counter() - t, 1)}),
              flush=True)
        correct.setdefault(label, []).append(r["correct"])
        for k, v in checks.items():
            readings.setdefault(label, {}).setdefault(k, []).append(v)
    summary = {}
    for label, nums in readings.items():
        pick = max if label == "program" else min
        summary[label] = {k: pick(float("inf") if x is None else x for x in v)
                          for k, v in nums.items()}
        summary[label]["correct_runs"] = f"{sum(correct[label])}/{len(correct[label])}"
    print(json.dumps({"workload": o.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
