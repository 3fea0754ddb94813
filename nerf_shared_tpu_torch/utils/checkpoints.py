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
schedule's count resumes at the largest group count, as in JAX.

The EMA shadow (--ema_decay, train/state.py) is the ``.ckpt.npz``'s
``ema/<branch>/...`` sidecar, in the params' flat layout, as the JAX
``save_native(..., ema=)`` writes it; ``read_native_ema`` reads it (None
for a pre-EMA file or a ``.tar``, where a run with --ema_decay restarts
the shadow at the loaded weights). A run or an eval engine with
--ema_decay reads a ``.tar``'s same-step ``.ckpt.npz`` sibling instead, so
under the default ``--ckpt_format both`` the shadow survives a resume and
reaches ``render_only`` and the service (the JAX loader takes the ``.tar``
there and restarts the shadow, ROADMAP C). The loss map is not saved.

The per-image groups (pose twists, appearance; train/state.py
``AUX_GROUPS``) go in the ``.ckpt.npz`` only, as the JAX package keeps
them: ``params/pose_twists``, ``params/appearance/gain|offset`` and their
moments in their own ``opt/g<i>/`` groups (labels "appearance", "net",
"pose" sorted). The ``.tar`` stays the reference's field-only layout. A
resume with the flags on takes a ``.tar``'s same-step ``.ckpt.npz``
sibling when there is one; otherwise, and when a file lacks the groups or
carries groups the run does not train, it prints the JAX package's
message and restarts every Adam moment (``restore_train_state``).

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
from nerf_shared_tpu_torch.train.state import AUX_GROUPS, group_label

# the run-time message names of the per-image groups, as the JAX loader
# prints them (params key -> label)
_AUX_LABELS = {"pose_twists": "--refine_poses pose twists",
               "appearance": "--appearance exposure corrections"}


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
        ckpt.get("optimizer_state_dict"), n), {}


def load_tar(path: str) -> Tuple[Dict, Optional[Dict], int]:
    """Read a reference-schema ``.tar`` -> (coarse_sd, fine_sd | None, step)."""
    return read_tar(path)[:3]


def _params_in_order(coarse_sd, fine_sd, aux):
    """(flat key, tensor, torch -> JAX layout, group label) of every
    parameter in the TrainState's order: the fields, then the aux groups."""
    out = []
    for branch, sd in (("coarse", coarse_sd), ("fine", fine_sd)):
        for name in param_order(sd or {}):
            out.append((f"{branch}/{_flat_key(name)}", sd[name], _jax_layout(name),
                        group_label(name)))
    for name, t in (aux or {}).items():
        out.append((name.replace(".", "/"), t, lambda a: a, AUX_GROUPS[name]))
    return out


def save_native(path: str, coarse_sd: Dict[str, torch.Tensor],
                fine_sd: Optional[Dict[str, torch.Tensor]], global_step: int,
                opt: Optional[Dict] = None,
                aux: Optional[Dict[str, torch.Tensor]] = None,
                ema: Optional[Dict[str, Dict[str, torch.Tensor]]] = None):
    """Write the JAX package's ``.ckpt.npz`` schema: params and, given
    ``opt`` ({"count", "exp_avg", "exp_avg_sq"} per parameter index, coarse
    then fine then ``aux``, torch layout; zeros where None), the Adam
    moments. With ``opt["groups"]`` (the group labels) and ``opt["step"]``
    (Adam's count per parameter) the moments go into the multi-group
    schema, each field parameter into the group ``group_label`` gives it,
    each ``aux`` one (AUX_GROUPS names) into its own. ``ema`` ({"coarse",
    "fine": state dict}) goes in the ``ema/`` sidecar."""
    groups = sorted((opt or {}).get("groups", ["net"]))
    multi = len(groups) > 1
    counts = {}
    flat = {}
    for idx, (key, tensor, tr, label) in enumerate(_params_in_order(coarse_sd, fine_sd, aux)):
        t = tensor.detach().cpu().numpy()
        flat[f"params/{key}"] = np.ascontiguousarray(tr(t))
        if opt is None:
            continue
        pre = "opt/"
        if multi:
            gi = groups.index(label)
            pre = f"opt/g{gi}/"
            counts.setdefault(gi, int(opt["step"][idx]))
        for part, src in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            m = opt[src][idx]
            m = np.zeros_like(t) if m is None else m.detach().cpu().numpy()
            flat[f"{pre}{part}/{key}"] = np.ascontiguousarray(tr(m))
    if ema is not None:
        for key, tensor, tr, _ in _params_in_order(ema["coarse"], ema.get("fine"), None):
            flat[f"ema/{key}"] = np.ascontiguousarray(tr(tensor.detach().cpu().numpy()))
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
    as _opt_from_tar gives it, or None, aux); MLP weights converted through
    ``params_from_jax``, grid-family parameters through
    ``params_tree_from_jax``; ``aux`` maps the per-image groups the file
    carries (AUX_GROUPS names) to tensors, and the Adam state's lists run
    over the fields and then these."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    step = int(flat.pop("global_step"))
    tree = _unflatten({k[len("params/"):]: v for k, v in flat.items()
                       if k.startswith("params/")})
    aux = {}
    for name in AUX_GROUPS:
        key = "params/" + name.replace(".", "/")
        if key in flat:
            aux[name] = torch.from_numpy(np.array(flat[key], np.float32))
    extra = set(tree) - {"coarse", "fine"} - {k.split(".")[0] for k in AUX_GROUPS}
    if extra:
        raise ValueError(f"{path}: unknown parameter groups {sorted(extra)}")
    coarse = _branch_from_jax(tree["coarse"])
    fine = _branch_from_jax(tree["fine"]) if "fine" in tree else None
    n_groups = int(flat["opt/n_groups"]) if "opt/n_groups" in flat else 0
    if not n_groups and "opt/count" not in flat:
        return coarse, fine, step, None, aux
    prefixes = [f"opt/g{i}/" for i in range(n_groups)] or ["opt/"]
    counts = [int(flat[p + "count"]) for p in prefixes]
    opt = {"count": max(counts), "step": [], "exp_avg": [], "exp_avg_sq": []}
    for key, _, tr, _ in _params_in_order(coarse, fine, aux):
        gi = next((i for i, p in enumerate(prefixes) if f"{p}mu/{key}" in flat), None)
        if gi is None:
            raise ValueError(f"{path}: no Adam moments for {key}")
        opt["step"].append(counts[gi])
        for part, dst in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            a = flat[f"{prefixes[gi]}{part}/{key}"]
            opt[dst].append(torch.from_numpy(np.ascontiguousarray(tr(a))))
    return coarse, fine, step, opt, aux


def _branch_from_jax(tree):
    """A JAX branch pytree -> state dict (MLP or grid family)."""
    return (params_from_jax if "pts_linears" in tree else params_tree_from_jax)(tree)


def read_native_ema(path: str) -> Optional[Dict[str, Dict[str, torch.Tensor]]]:
    """The EMA sidecar of a ``.ckpt.npz`` as {"coarse", "fine": state
    dict}, or None (a pre-EMA file or a ``.tar``), as JAX's
    ``load_native_ema``."""
    if not path.endswith(".npz"):
        return None
    with np.load(path) as z:
        flat = {k[len("ema/"):]: z[k] for k in z.files if k.startswith("ema/")}
    if not flat:
        return None
    return {b: _branch_from_jax(t) for b, t in _unflatten(flat).items()}


def load_native(path: str) -> Tuple[Dict, Optional[Dict], int]:
    """Read the params half of a JAX ``.ckpt.npz`` -> (coarse_sd,
    fine_sd | None, step)."""
    return read_native(path)[:3]


def newest_checkpoint(args, native: bool = False) -> Optional[str]:
    """The checkpoint the resume rule picks, or None (none, or
    --no_reload); with ``native`` a ``.tar``'s same-step ``.ckpt.npz``
    sibling instead, which carries the per-image groups and the EMA."""
    ckpts = find_checkpoints(args.basedir, args.expname, args.ft_path)
    if not ckpts or args.no_reload:
        return None
    path = ckpts[-1]
    sibling = path[: -len(".tar")] + ".ckpt.npz"
    if native and path.endswith(".tar") and sibling in ckpts:
        return sibling
    return path


def load_checkpoint(args, ema: bool = False) -> Tuple[Optional[Dict], Optional[Dict], int]:
    """The newest checkpoint's (coarse_sd, fine_sd, step), or
    (None, None, 0) when there is none or ``--no_reload`` is set. With
    ``ema`` the weights are the checkpoint's EMA shadow (from the
    ``.ckpt.npz`` sibling of a ``.tar``) when it has one."""
    path = newest_checkpoint(args, native=ema)
    if path is None:
        return None, None, 0
    print(f"Reloading from {path}")
    coarse, fine, step = load_native(path) if path.endswith(".npz") else load_tar(path)
    shadow = read_native_ema(path) if ema else None
    if shadow is not None:
        coarse, fine = shadow["coarse"], shadow.get("fine")
    return coarse, fine, step


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
        params = state.parameters() + list(state.aux.values())
        st = [state.optimizer.state.get(p, {}) for p in params]
        opt = {"count": state.count,
               "groups": [g["label"] for g in state.optimizer.param_groups],
               "step": [int(s["step"]) if "step" in s else 0 for s in st],
               "exp_avg": [s.get("exp_avg") for s in st],
               "exp_avg_sq": [s.get("exp_avg_sq") for s in st]}
        paths.append(os.path.join(expdir, f"{i:06d}.ckpt.npz"))
        save_native(paths[-1], coarse_sd, fine_sd, state.step, opt, aux=state.aux,
                    ema=state.ema)
    if fmt in ("tar", "both") and tar_able:
        # the reference layout holds the fields' Adam alone: the aux groups
        # come after the fields' indices, so keep the field groups' entries
        n_fields = len(state.parameters())
        opt_sd = {"state": {k: v for k, v in opt_sd["state"].items() if k < n_fields},
                  "param_groups": [g for g in opt_sd["param_groups"]
                                   if g["label"] in ("net", "grid")]}
        paths.append(os.path.join(expdir, f"{i:06d}.tar"))
        save_tar(paths[-1], coarse_sd, fine_sd, state.step, opt_sd)
    return paths


def restore_train_state(state, args) -> int:
    """Load the newest checkpoint (resume rule above) into a TrainState:
    weights, global step and, when the file has it, Adam's moments and
    count (which keeps the learning rate on schedule). Returns the start
    step (0 when nothing was loaded).

    The per-image groups follow the JAX ``load_checkpoint``: a run that
    trains them (or keeps an EMA) takes a ``.tar``'s same-step
    ``.ckpt.npz`` sibling; a file
    without a group the run trains starts it at identity, a file with a
    group the run does not train drops it, and either way every Adam moment
    restarts (count 0), each with the JAX package's message. A state with
    an EMA shadow takes the file's ``ema/`` sidecar, or restarts the shadow
    at the loaded weights when the file has none."""
    wanted = {k.split(".")[0] for k in state.aux}
    path = newest_checkpoint(args, native=bool(wanted) or state.ema is not None)
    if path is None:
        return 0
    print(f"Reloading from {path}")
    coarse_sd, fine_sd, step, opt, aux = (read_native(path) if path.endswith(".npz")
                                          else read_tar(path))
    have = {k.split(".")[0] for k in aux}
    for group, label in _AUX_LABELS.items():
        if not path.endswith(".npz"):
            if group in wanted:
                print(f"torch .tar has no {label} group: starting at "
                      "identity (Adam moments reset — the .tar's single-adam "
                      "schema cannot map onto the group split)")
                opt = None
        elif group in have and group not in wanted:
            print(f"checkpoint carries {label} but the flag is off: "
                  "dropping them (Adam moments reset)")
            opt = None
        elif group in wanted and group not in have:
            print(f"{label} requested but absent from the checkpoint: "
                  "starting them at identity (Adam moments reset)")
            opt = None
    state.coarse.load_state_dict(coarse_sd, strict=True)
    if state.fine is not None and fine_sd:
        state.fine.load_state_dict(fine_sd, strict=True)
    with torch.no_grad():
        for k, p in state.aux.items():
            if k in aux:
                if tuple(aux[k].shape) != tuple(p.shape):
                    raise ValueError(f"{path}: {k} has shape {tuple(aux[k].shape)}, "
                                     f"the run trains {tuple(p.shape)}")
                p.copy_(aux[k])
            else:
                p.zero_()
    params = state.parameters() + list(state.aux.values())
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
    if state.ema is not None:
        ema = read_native_ema(path)
        if ema is None:
            state.init_ema()
        else:
            for b, shadow in state.ema.items():
                for k, t in shadow.items():
                    t.copy_(ema[b][k])
    state.step = step
    return step
