"""The comparisons that decide ``correct``: each reduces what the program
produced and what the reference worked out to one number, held against
the cell's limit (``limits/<workload>.json``).
"""

from __future__ import annotations

import statistics
from typing import Dict, Tuple

import torch


def worst(a: float, b: float) -> float:
    """The larger of two gaps; NaN when either is (a NaN never passes)."""
    return a if a != a or b <= a else b


def loss_gap(prog: list, ref: list) -> float:
    """The widest relative gap of a step's loss."""
    gap = 0.0
    for p, r in zip(prog, ref):
        gap = worst(gap, abs(p - r) / abs(r))
    return gap


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> Dict[str, float]:
    """Each leaf's gap of norms: |‖prog‖ - ‖ref‖| over the larger of that
    leaf's reference norm and the median leaf's. ``keep`` names the leaves
    compared (all by default); a leaf the program lacks reads norm 0."""
    med = statistics.median(ref.values())
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med)
            for k in (keep if keep is not None else ref)}


def norm_gap(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> Tuple[float, str]:
    """The worst leaf's gap of norms (``leaf_gaps``). Returns (gap, leaf)."""
    gap, leaf = 0.0, ""
    for k, g in leaf_gaps(prog, ref, keep).items():
        if gap == gap and (g != g or g > gap):
            gap, leaf = g, k
    return gap, leaf


def median_gap(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> float:
    """The median leaf's gap of norms (``leaf_gaps``); NaN when any is."""
    gaps = list(leaf_gaps(prog, ref, keep).values())
    return float("nan") if any(g != g for g in gaps) else statistics.median(gaps)


def moving_leaves(grad_norms: Dict[str, float], share: float = 1e-3) -> list:
    """Leaves whose reference gradient is at least ``share`` of the median
    leaf's: the others move under Adam by round-off alone."""
    med = statistics.median(grad_norms.values())
    return [k for k, v in grad_norms.items() if v >= share * med]


def frame_gaps(prog: torch.Tensor, ref: torch.Tensor, sigma_last: torch.Tensor,
               flip_band: float) -> Dict[str, float]:
    """|prog - ref| over a frame's pixels and channels: its widest
    ("max") and its 50th, 90th and 99th percentiles ("p50", ...), leaving
    out the rays whose last sample's density lies within ``flip_band`` of
    0 (where the 1e10 final interval turns its alpha from 0 to 1 on any
    rounding), and the share of rays left out ("left_out")."""
    keep = sigma_last.abs() >= flip_band
    left_out = 1.0 - float(keep.float().mean())
    diff = (prog.to(ref.device, ref.dtype) - ref)[keep].abs().reshape(-1).cpu()
    if diff.numel() == 0:
        return {"max": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0, "left_out": left_out}
    if bool(torch.isnan(diff).any()):
        nan = float("nan")
        return {"max": nan, "p50": nan, "p90": nan, "p99": nan, "left_out": left_out}
    out = {"max": float(diff.max()), "left_out": left_out}
    for q in (50, 90, 99):
        out[f"p{q}"] = float(torch.kthvalue(diff, max(1, int(q / 100 * diff.numel()))).values)
    return out
