"""Checkpoint discovery, ``.tar`` save/load, and the params half of the JAX
package's native ``.ckpt.npz``.

Counterpart of ``find_checkpoints``, ``save_tar``, ``load_tar`` and
``load_native`` in ``nerf_shared_tpu/utils/checkpoints.py``. The ``.tar`` is
the reference schema (utils.py:444-456): ``global_step``,
``coarse_model_state_dict``, ``fine_model_state_dict`` (empty for
coarse-only runs) and ``optimizer_state_dict``. This slice serves
checkpoints, so it reads and writes the weights only: the optimizer and
EMA state are neither restored nor written (the saved optimizer dict is
empty, which the JAX loader reads as "no Adam state").

Resume rule (reference utils.py:174-214): the newest file in
``{basedir}/{expname}`` wins, ``ft_path`` overrides, ``no_reload`` disables.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nerf_shared_tpu_torch.models.nerf import params_from_jax


def find_checkpoints(basedir: str, expname: str,
                     ft_path: Optional[str] = None) -> list:
    """Candidate checkpoints sorted oldest -> newest (reference utils.py:185-189)."""
    if ft_path is not None and ft_path != "None":
        return [ft_path]
    expdir = os.path.join(basedir, expname)
    if not os.path.isdir(expdir):
        return []
    return [
        os.path.join(expdir, f)
        for f in sorted(os.listdir(expdir))
        if ("tar" in f or f.endswith(".ckpt.npz"))
    ]


def save_tar(path: str, coarse_sd: Dict[str, torch.Tensor],
             fine_sd: Optional[Dict[str, torch.Tensor]], global_step: int):
    """Write the reference ``.tar`` schema from two state dicts (tensors are
    stored on the CPU)."""
    def cpu(sd):
        return {k: v.detach().cpu().contiguous() for k, v in (sd or {}).items()}

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(
        {
            "global_step": int(global_step),
            "coarse_model_state_dict": cpu(coarse_sd),
            "fine_model_state_dict": cpu(fine_sd),
            "optimizer_state_dict": {"state": {}, "param_groups": []},
        },
        path,
    )


def load_tar(path: str) -> Tuple[Dict, Optional[Dict], int]:
    """Read a reference-schema ``.tar`` -> (coarse_sd, fine_sd | None, step)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    fine = ckpt.get("fine_model_state_dict") or None
    return ckpt["coarse_model_state_dict"], fine, int(ckpt["global_step"])


def _unflatten(flat: Dict[str, np.ndarray]):
    """'a/0/w'-keyed arrays -> nested dicts, with digit-keyed levels as lists."""
    root: Dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(re.fullmatch(r"\d+", k) for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def load_native(path: str) -> Tuple[Dict, Optional[Dict], int]:
    """Read the params half of a JAX ``.ckpt.npz`` -> (coarse_sd,
    fine_sd | None, step), converted through ``params_from_jax``."""
    with np.load(path) as z:
        flat = {k[len("params/"):]: z[k] for k in z.files
                if k.startswith("params/")}
        step = int(z["global_step"])
    tree = _unflatten(flat)
    if "pts_linears" not in tree.get("coarse", {}):
        raise NotImplementedError(
            f"{path}: only the 'nerf' MLP family is ported (ROADMAP A15)")
    fine = params_from_jax(tree["fine"]) if "fine" in tree else None
    return params_from_jax(tree["coarse"]), fine, step


def load_checkpoint(args) -> Tuple[Optional[Dict], Optional[Dict], int]:
    """The newest checkpoint's (coarse_sd, fine_sd, step), or
    (None, None, 0) when there is none or ``--no_reload`` is set."""
    ckpts = find_checkpoints(args.basedir, args.expname, args.ft_path)
    if not ckpts or args.no_reload:
        return None, None, 0
    path = ckpts[-1]
    print(f"Reloading from {path}")
    if path.endswith(".npz"):
        return load_native(path)
    return load_tar(path)
