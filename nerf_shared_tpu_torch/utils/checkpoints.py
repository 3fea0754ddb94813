"""Checkpoint discovery and the two checkpoint formats, with Adam state.

Counterpart of ``nerf_shared_tpu/utils/checkpoints.py``:

- the ``.tar`` is the reference schema (utils.py:444-456): ``global_step``,
  ``coarse_model_state_dict``, ``fine_model_state_dict`` (empty for
  coarse-only runs) and ``optimizer_state_dict``, which is the torch Adam
  state dict itself: ``state[i] = {step, exp_avg, exp_avg_sq}`` for the
  i-th parameter, coarse then fine in ``torch_param_order``;
- the ``.ckpt.npz`` is the JAX package's flat schema: ``params/<branch>/...``
  (weights [in, out]; grid tables and planes as they are), and Adam:
  ``opt/count``, ``opt/mu/...`` and ``opt/nu/...`` in the same layout for
  one group, or for the grid families' two groups ``opt/n_groups`` and
  ``opt/g<i>/count|mu/...|nu/...`` in the JAX traversal order of the
  groups (their labels sorted: g0 "grid", g1 "net"), each holding only its
  own parameters; and ``global_step``.

Both cross with the JAX package's loaders and savers both ways. The grid
families have no ``.tar`` layout (the reference schema is the MLP's): a
``tar`` save of grid parameters raises and ``both`` writes the
``.ckpt.npz`` alone, as in the JAX package. A file without Adam state (an
empty optimizer dict) resumes as the JAX ``load_checkpoint`` does: weights
and global step restored, Adam fresh at count 0. On a multi-group file the
schedule's count resumes at the largest group count, as in JAX. EMA and
the pose and appearance groups are not ported (ROADMAP A11).

Resume rule (reference utils.py:174-214): the newest file in
``{basedir}/{expname}`` wins, ``ft_path`` overrides, ``no_reload`` disables.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nerf_shared_tpu_torch.models.nerf import params_from_jax, params_tree_from_jax
from nerf_shared_tpu_torch.train.state import group_label


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


_MODULE_RANK = {"pts_linears": 0, "views_linears": 1, "feature_linear": 2,
                "alpha_linear": 3, "rgb_linear": 4, "output_linear": 5,
                # the grid families: tables / planes, then the decoder
                "tables": 0, "planes": 0, "sigma_net": 1, "sigma": 1,
                "rgb_net": 2, "rgb": 2}


def param_order(names) -> list:
    """State-dict names in the order the TrainState indexes them: the
    reference module's for the MLP (what ``torch_param_order`` gives), the
    modules' registration order for the grid families."""
    def rank(name):
        parts = name.split(".")
        idx = next((int(p) for p in parts[1:] if p.isdigit()), 0)
        return _MODULE_RANK[parts[0]], idx, parts[-1] == "bias"
    return sorted(names, key=rank)


def _flat_key(name: str) -> str:
    """'pts_linears.0.weight' -> 'pts_linears/0/w', 'tables.3' ->
    'tables/3' (the JAX flat key)."""
    parts = name.split(".")
    last = {"weight": "w", "bias": "b"}.get(parts[-1], parts[-1])
    return "/".join(parts[:-1] + [last])


def _jax_layout(name: str):
    """torch -> JAX layout of a parameter (dense weights transpose)."""
    return (lambda a: a.T) if name.endswith(".weight") else (lambda a: a)


def _is_mlp(sd) -> bool:
    return any(k.startswith("pts_linears.") for k in sd)


def _cpu(sd):
    return {k: v.detach().cpu().contiguous() for k, v in (sd or {}).items()}


def save_tar(path: str, coarse_sd: Dict[str, torch.Tensor],
             fine_sd: Optional[Dict[str, torch.Tensor]], global_step: int,
             optimizer_state: Optional[Dict] = None):
    """Write the reference ``.tar`` schema from two state dicts and, when
    given, a torch Adam state dict (tensors are stored on the CPU; without
    one the optimizer dict is empty: "no Adam state")."""
    opt = {"state": {}, "param_groups": []}
    if optimizer_state is not None:
        opt = {"state": {i: _cpu(st) for i, st in optimizer_state["state"].items()},
               "param_groups": optimizer_state["param_groups"]}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(
        {
            "global_step": int(global_step),
            "coarse_model_state_dict": _cpu(coarse_sd),
            "fine_model_state_dict": _cpu(fine_sd),
            "optimizer_state_dict": opt,
        },
        path,
    )


def _opt_from_tar(opt_sd: Dict, n_params: int) -> Optional[Dict]:
    """{"count", "step": [..], "exp_avg": [..], "exp_avg_sq": [..]} per
    parameter index (None where a state is absent), or None without Adam
    state. ``count`` is the schedule's count, ``step`` Adam's own."""
    if not (opt_sd or {}).get("state"):
        return None
    out = {"count": 0, "exp_avg": [None] * n_params, "exp_avg_sq": [None] * n_params}
    for i in range(n_params):
        st = opt_sd["state"].get(i)
        if st is not None:
            out["exp_avg"][i], out["exp_avg_sq"][i] = st["exp_avg"], st["exp_avg_sq"]
            out["count"] = int(st["step"])
    out["step"] = [out["count"]] * n_params
    return out


def read_tar(path: str):
    """A reference-schema ``.tar`` -> (coarse_sd, fine_sd | None, step,
    Adam state as _opt_from_tar gives it)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    coarse = ckpt["coarse_model_state_dict"]
    fine = ckpt.get("fine_model_state_dict") or None
    n = len(coarse) + len(fine or {})
    return coarse, fine, int(ckpt["global_step"]), _opt_from_tar(
        ckpt.get("optimizer_state_dict"), n)


def load_tar(path: str) -> Tuple[Dict, Optional[Dict], int]:
    """Read a reference-schema ``.tar`` -> (coarse_sd, fine_sd | None, step)."""
    return read_tar(path)[:3]


def save_native(path: str, coarse_sd: Dict[str, torch.Tensor],
                fine_sd: Optional[Dict[str, torch.Tensor]], global_step: int,
                opt: Optional[Dict] = None):
    """Write the JAX package's ``.ckpt.npz`` schema: params and, given
    ``opt`` ({"count", "exp_avg", "exp_avg_sq"} per parameter index, coarse
    then fine, torch layout; zeros where None), the Adam moments. With
    ``opt["groups"]`` (the group labels) and ``opt["step"]`` (Adam's count
    per parameter) the moments go into the multi-group schema, each
    parameter into the group ``group_label`` gives it."""
    groups = sorted((opt or {}).get("groups", ["net"]))
    multi = len(groups) > 1
    counts = {}
    flat, idx = {}, 0
    for branch, sd in (("coarse", coarse_sd), ("fine", fine_sd)):
        for name in param_order(sd or {}):
            key = f"{branch}/{_flat_key(name)}"
            t = sd[name].detach().cpu().numpy()
            tr = _jax_layout(name)
            flat[f"params/{key}"] = np.ascontiguousarray(tr(t))
            if opt is not None:
                pre = "opt/"
                if multi:
                    gi = groups.index(group_label(name))
                    pre = f"opt/g{gi}/"
                    counts.setdefault(gi, int(opt["step"][idx]))
                for part, src in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                    m = opt[src][idx]
                    m = np.zeros_like(t) if m is None else m.detach().cpu().numpy()
                    flat[f"{pre}{part}/{key}"] = np.ascontiguousarray(tr(m))
            idx += 1
    if opt is not None and multi:
        flat["opt/n_groups"] = np.asarray(len(groups))
        for gi in range(len(groups)):
            flat[f"opt/g{gi}/count"] = np.asarray(
                counts.get(gi, max(opt["step"], default=0)), np.int32)
    elif opt is not None:
        flat["opt/count"] = np.asarray(opt["count"], np.int32)
    flat["global_step"] = np.asarray(global_step, np.int64)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


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


def read_native(path: str):
    """A JAX ``.ckpt.npz`` -> (coarse_sd, fine_sd | None, step, Adam state
    as _opt_from_tar gives it, or None); MLP weights converted through
    ``params_from_jax``, grid-family parameters through
    ``params_tree_from_jax``."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    step = int(flat.pop("global_step"))
    tree = _unflatten({k[len("params/"):]: v for k, v in flat.items()
                       if k.startswith("params/")})
    extra = set(tree) - {"coarse", "fine"}
    if extra:
        raise NotImplementedError(
            f"{path}: parameter groups {sorted(extra)} (pose or appearance) are "
            "not ported to nerf_shared_tpu_torch yet: ROADMAP A11")
    convert = {b: (params_from_jax if "pts_linears" in t else params_tree_from_jax)
               for b, t in tree.items()}
    coarse = convert["coarse"](tree["coarse"])
    fine = convert["fine"](tree["fine"]) if "fine" in tree else None
    n_groups = int(flat["opt/n_groups"]) if "opt/n_groups" in flat else 0
    if not n_groups and "opt/count" not in flat:
        return coarse, fine, step, None
    prefixes = [f"opt/g{i}/" for i in range(n_groups)] or ["opt/"]
    counts = [int(flat[p + "count"]) for p in prefixes]
    opt = {"count": max(counts), "step": [], "exp_avg": [], "exp_avg_sq": []}
    for branch, sd in (("coarse", coarse), ("fine", fine)):
        for name in param_order(sd or {}):
            key = f"{branch}/{_flat_key(name)}"
            gi = next((i for i, p in enumerate(prefixes) if f"{p}mu/{key}" in flat), None)
            if gi is None:
                raise ValueError(f"{path}: no Adam moments for {key}")
            opt["step"].append(counts[gi])
            for part, dst in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                a = flat[f"{prefixes[gi]}{part}/{key}"]
                opt[dst].append(torch.from_numpy(np.ascontiguousarray(
                    _jax_layout(name)(a))))
    return coarse, fine, step, opt


def load_native(path: str) -> Tuple[Dict, Optional[Dict], int]:
    """Read the params half of a JAX ``.ckpt.npz`` -> (coarse_sd,
    fine_sd | None, step)."""
    return read_native(path)[:3]


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


def save_checkpoints(basedir: str, expname: str, state, i: int,
                     fmt: str = "both") -> list:
    """Save a TrainState as ``{i:06d}.ckpt.npz`` and/or ``{i:06d}.tar``
    under {basedir}/{expname} (``fmt``: native, tar or both), with its Adam
    state; returns the paths written. Grid-family parameters have no
    ``.tar`` layout: ``tar`` raises, ``both`` writes the ``.ckpt.npz``."""
    if fmt not in ("native", "tar", "both"):
        raise ValueError(f"unknown checkpoint format {fmt!r} (native | tar | both)")
    expdir = os.path.join(basedir, expname)
    coarse_sd = state.coarse.state_dict()
    fine_sd = state.fine.state_dict() if state.fine is not None else {}
    tar_able = _is_mlp(coarse_sd) and (not fine_sd or _is_mlp(fine_sd))
    if fmt == "tar" and not tar_able:
        raise ValueError(
            "torch .tar export is only defined for the 'nerf' model family "
            "(the reference checkpoint schema has no grid-parameter layout); "
            "use --ckpt_format native for this model")
    opt_sd = state.optimizer.state_dict()
    paths = []
    if fmt in ("native", "both"):
        params = state.parameters()
        st = [state.optimizer.state.get(p, {}) for p in params]
        opt = {"count": state.count,
               "groups": [g["label"] for g in state.optimizer.param_groups],
               "step": [int(s["step"]) if "step" in s else 0 for s in st],
               "exp_avg": [s.get("exp_avg") for s in st],
               "exp_avg_sq": [s.get("exp_avg_sq") for s in st]}
        paths.append(os.path.join(expdir, f"{i:06d}.ckpt.npz"))
        save_native(paths[-1], coarse_sd, fine_sd, state.step, opt)
    if fmt in ("tar", "both") and tar_able:
        paths.append(os.path.join(expdir, f"{i:06d}.tar"))
        save_tar(paths[-1], coarse_sd, fine_sd, state.step, opt_sd)
    return paths


def restore_train_state(state, args) -> int:
    """Load the newest checkpoint (resume rule above) into a TrainState:
    weights, global step and, when the file has it, Adam's moments and
    count (which keeps the learning rate on schedule). Returns the start
    step (0 when nothing was loaded)."""
    ckpts = find_checkpoints(args.basedir, args.expname, args.ft_path)
    if not ckpts or args.no_reload:
        return 0
    path = ckpts[-1]
    print(f"Reloading from {path}")
    coarse_sd, fine_sd, step, opt = (read_native(path) if path.endswith(".npz")
                                     else read_tar(path))
    state.coarse.load_state_dict(coarse_sd, strict=True)
    if state.fine is not None and fine_sd:
        state.fine.load_state_dict(fine_sd, strict=True)
    params = state.parameters()
    state.optimizer.state.clear()
    state.count = 0
    if opt is not None:
        if len(opt["exp_avg"]) != len(params):
            raise ValueError(f"{path}: Adam state for {len(opt['exp_avg'])} "
                             f"parameters, the model has {len(params)}")
        for p, n, m, v in zip(params, opt["step"], opt["exp_avg"], opt["exp_avg_sq"]):
            state.optimizer.state[p] = {
                "step": torch.tensor(float(n)),
                "exp_avg": (torch.zeros_like(p) if m is None else m.to(p)).contiguous(),
                "exp_avg_sq": (torch.zeros_like(p) if v is None else v.to(p)).contiguous(),
            }
        state.count = opt["count"]
    state.step = step
    return step
