"""The harness's hold on the measured program, ``nerf_shared_tpu_torch``:
its arguments parsed by its own parser from the configuration's flags,
the benchmark's weights put into its networks, and its kernels' launch
counters.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict

import torch

# the program's modules whose launch counters the metrics read, and the
# counter of each kernel (module, attribute)
COUNTERS = {
    "B1": ("nerf_shared_tpu_torch.ops.cuda.fused_mlp", "POINT_LAUNCHES"),
    "B1 bf16": ("nerf_shared_tpu_torch.ops.cuda.fused_mlp", "POINT_LAUNCHES_BF16"),
    "B2": ("nerf_shared_tpu_torch.ops.cuda.fused_mlp_bwd", "LAUNCHES"),
    "B2 bf16": ("nerf_shared_tpu_torch.ops.cuda.fused_mlp_bwd", "LAUNCHES_BF16"),
    "B3": ("nerf_shared_tpu_torch.ops.cuda.fused_mlp", "LAUNCHES"),
    "B3 bf16": ("nerf_shared_tpu_torch.ops.cuda.fused_mlp", "LAUNCHES_BF16"),
    "B5": ("nerf_shared_tpu_torch.ops.cuda.composite", "LAUNCHES"),
}


def counters() -> Dict[str, int]:
    import importlib

    return {k: int(getattr(importlib.import_module(m), a)) for k, (m, a) in COUNTERS.items()}


def parse_args(cfg: dict, traffic: dict, seed: int, device, workdir: Path,
               extra: Dict[str, object] = None):
    """The program's argument namespace: the configuration's flags, then
    the traffic mix's, then ``extra``, written as the program's own
    ``key = value`` config file and read by its parser."""
    from nerf_shared_tpu_torch.config import config_parser

    flags = {**cfg["flags"], **traffic.get("flags", {}), **(extra or {})}
    workdir.mkdir(parents=True, exist_ok=True)
    path = workdir / "scene.txt"
    path.write_text("".join(f"{k} = {v}\n" for k, v in flags.items()))
    argv = ["--config", str(path), "--device", str(device),
            "--basedir", str(workdir / "logs"), "--jax_seed", str(int(seed) % (1 << 31)),
            "--no_reload"]
    return config_parser().parse_args(argv)


@torch.no_grad()
def load_weights(module, leaves: Dict[str, torch.Tensor]):
    """Copy the benchmark's leaves into a program network, name by name;
    raises when the names differ."""
    params = dict(module.named_parameters())
    if set(params) != set(leaves):
        raise ValueError(f"weights differ in names: {sorted(set(params) ^ set(leaves))}")
    for k, p in params.items():
        p.copy_(leaves[k])


def work_dir() -> Path:
    """A directory under the run's TMPDIR for the program's config file
    and its (unused) log directory."""
    import tempfile

    return Path(tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR")))
