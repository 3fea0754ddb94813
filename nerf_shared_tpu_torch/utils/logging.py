"""Console / TensorBoard logging and experiment provenance.

Counterpart of ``nerf_shared_tpu/utils/logging.py`` (reference
utils.py:315-328, 488-494): args.txt and config.txt copied into the
experiment directory, ``[TRAIN]`` console lines, and optional TensorBoard
scalars (import-gated: without the tensorboard package the run goes on
without it).
"""

from __future__ import annotations

import os
from typing import Optional


def copy_log_dir(args) -> str:
    """Write args.txt (every flag) and config.txt (the config file) into
    {basedir}/{expname}."""
    expdir = os.path.join(args.basedir, args.expname)
    os.makedirs(expdir, exist_ok=True)
    with open(os.path.join(expdir, "args.txt"), "w") as f:
        for k in sorted(vars(args)):
            f.write(f"{k} = {getattr(args, k)}\n")
    if getattr(args, "config", None):
        with open(args.config) as src, open(os.path.join(expdir, "config.txt"), "w") as f:
            f.write(src.read())
    return expdir


def make_tb_writer(args):
    """A SummaryWriter at {expdir}/tb_logs under --tensorboard, else None."""
    if not getattr(args, "tensorboard", False):
        return None
    try:
        from torch.utils.tensorboard.writer import SummaryWriter
    except ImportError:
        print("tensorboard requested but not importable; continuing without")
        return None
    return SummaryWriter(log_dir=os.path.join(args.basedir, args.expname, "tb_logs"))


def print_statistics(loss, psnr, i: int, tb_writer=None, extra: Optional[dict] = None):
    """The console line and TB scalars (reference tag names)."""
    msg = f"[TRAIN] Iter: {i} Loss: {float(loss)}  PSNR: {float(psnr)}"
    if extra:
        msg += "".join(f"  {k}: {v}" for k, v in extra.items())
    print(msg, flush=True)
    if tb_writer is not None:
        tb_writer.add_scalar("Test/Loss", float(loss), i)
        tb_writer.add_scalar("Test/PSNR", float(psnr), i)
        for k, v in (extra or {}).items():
            try:
                tb_writer.add_scalar(f"Train/{k}", float(v), i)
            except (TypeError, ValueError):
                pass
