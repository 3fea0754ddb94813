"""Numerical debugging aids (--debug_nans).

Counterpart of ``nerf_shared_tpu/utils/debug.py``, with its messages:

- ``enable_nan_checks(enable)``: the JAX package turns on jax_debug_nans,
  which raises at the first primitive (a Pallas kernel among them) that
  produces a NaN. The port turns on two things instead: autograd's anomaly
  mode (``torch.autograd.set_detect_anomaly``), which raises at the first
  backward function that returns a NaN and names it, and a finite check on
  the inputs and the outputs of every kernel wrapper (B1-B5, P1, P2, both
  dtypes; on a CPU tensor around the plain version), which raises
  FloatingPointError naming the kernel, the wrapper, the tensor and its
  count of non-finite values (``ops/cuda/common.check_finite``). The
  inputs are checked too because a kernel's ReLU (fmaxf) turns a NaN into
  0: a NaN point or weight may leave no trace in B1's output. Each check
  reads its counts back to the host, a sync a check; with the checks off
  it costs nothing.
- ``check_finite(tree, name)``: a host-side scan of a nested dict / list /
  tuple of tensors or arrays (metrics, parameters before a save).
- ``assert_shape(x, shape, name)``: a shape contract; None dims are free.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from nerf_shared_tpu_torch.ops.cuda import common


def enable_nan_checks(enable: bool = True) -> None:
    common.NAN_CHECKS = bool(enable)
    torch.autograd.set_detect_anomaly(bool(enable))


def _leaves(tree, path=""):
    """(path, leaf) in the order and spelling of jax.tree_util's
    flatten_with_path: dict keys sorted and written ``[key!r]``, sequence
    entries ``[i]``, the parts joined by "/"; None is an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        yield path, tree
        return
    for key, sub in items:
        yield from _leaves(sub, f"{path}/{key}" if path else key)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return np.asarray(leaf)


def check_finite(tree, name: str = "tree") -> None:
    for keys, leaf in _leaves(tree):
        arr = _to_numpy(leaf)
        if not np.isfinite(arr).all():
            n_bad = int((~np.isfinite(arr)).sum())
            raise FloatingPointError(
                f"[Numerical Error] {name}{keys} contains {n_bad} non-finite "
                f"values (shape {arr.shape})"
            )


def assert_shape(x, shape: Sequence[Optional[int]], name: str = "array") -> None:
    actual = tuple(x.shape)
    if len(actual) != len(shape) or any(
        want is not None and got != want for got, want in zip(actual, shape)
    ):
        raise AssertionError(
            f"{name}: expected shape {tuple(shape)}, got {actual}"
        )
