"""Tensor parallelism: the NeRF MLP's width sharded over a "model" axis of
process groups.

Counterpart of ``nerf_shared_tpu/parallel/tensor.py``. At the reference
width (W = 256) it does not pay: a 256-wide layer split t ways leaves
panels of 256/t columns and adds one collective a layer. It is the code
path for widths one card cannot hold. No entry point reads it, in the JAX
package or here (the trainer raises on a model axis, parallel/mesh.py).

Column-parallel, as in JAX:

- every wide weight is sharded on its output dimension over the model
  group (``pts_linears``, ``feature_linear``, ``views_linears``; the heads
  with 1 to 4 outputs stay replicated). The port's weights are [out, in],
  so a panel is a block of rows;
- each sharded layer computes its local [..., W/t] panel, adds its bias,
  applies ReLU and gathers the panels along the last dimension over the
  model group (one all-gather a sharded layer), so the skip concat and the
  heads see the full activation;
- with a data axis the points also split over the data group and the
  outputs gather back: rays over "data", weights over "model".

Forward only, as in JAX (no test takes a gradient through it). Its products
are plain ``F.linear``, as JAX's are jnp products outside any Pallas
kernel, so at t = 1 it is ``apply_nerf`` bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from nerf_shared_tpu_torch.models.nerf import NeRFConfig, Params, embed_inputs
from nerf_shared_tpu_torch.parallel.distributed import _all_gather_rows
from nerf_shared_tpu_torch.parallel.mesh import MeshGroups

# layers whose width is sharded (output dimension divisible by t); the
# small heads (alpha 1, rgb 3, output_ch) replicate
_SHARDED_KEYS = ("pts_linears", "feature_linear", "views_linears")


def _shardable(name: str, leaf_name: str, out_dim: int, t: int) -> bool:
    return name in _SHARDED_KEYS and out_dim % t == 0 and out_dim >= t


def _layer(key: str) -> str:
    """The layer group of a state-dict name ("pts_linears.3.weight" ->
    "pts_linears")."""
    return key.split(".")[0]


def tp_param_specs(params: Params, t: int) -> Dict[str, bool]:
    """Per leaf of the state dict: True if it is sharded over the model
    axis (weight rows and bias of a wide layer), False if replicated."""
    out = {}
    for k, v in params.items():
        w = params[k.rsplit(".", 1)[0] + ".weight"]
        out[k] = _shardable(_layer(k), k.rsplit(".", 1)[1], int(w.shape[0]), t)
    return out


def _panel(v: torch.Tensor, t: int, i: int) -> torch.Tensor:
    rows = v.shape[0] // t
    return v[i * rows:(i + 1) * rows].contiguous()


def tp_shard_params(groups: MeshGroups, params: Params) -> Dict[str, torch.Tensor]:
    """This rank's column-parallel layout: 1/t of every wide matrix and
    bias (its model rank's panel), the heads whole."""
    t, i = groups.model_size, groups.model_rank
    specs = tp_param_specs(params, t)
    return {k: (_panel(v, t, i) if specs[k] else v) for k, v in params.items()}


def _full_width(cfg: NeRFConfig, layer: str) -> int:
    """The unsharded output width of a layer group."""
    return max(cfg.W // 2, 1) if layer == "views_linears" else cfg.W


def _local(params: Params, cfg: NeRFConfig, groups: MeshGroups) -> Dict[str, torch.Tensor]:
    """``params`` as this rank's panels, whether it holds the replicated
    weights or ``tp_shard_params``' layout already (told apart by the
    leaf's rows against the layer's width)."""
    t, i = groups.model_size, groups.model_rank
    out = {}
    for k, v in params.items():
        width = _full_width(cfg, _layer(k))
        whole = _shardable(_layer(k), k.rsplit(".", 1)[1], width, t) and v.shape[0] == width
        out[k] = _panel(v, t, i) if whole and t > 1 else v
    return out


def _gather_cols(z: torch.Tensor, groups: MeshGroups) -> torch.Tensor:
    """The model group's panels [..., W/t] concatenated in rank order along
    the last dimension (a tiled all-gather)."""
    if groups.model_group is None:
        return z
    parts = [torch.empty_like(z) for _ in range(groups.model_size)]
    dist.all_gather(parts, z.contiguous(), group=groups.model_group)
    return torch.cat(parts, dim=-1)


def _apply_mlp_tp(local: Params, cfg: NeRFConfig, x: torch.Tensor,
                  groups: MeshGroups) -> torch.Tensor:
    """apply_mlp on column-sharded panels: activations are whole at every
    layer boundary; ReLU commutes with the column split, so it runs on the
    panel before the gather."""
    t = groups.model_size
    input_pts = x[..., : cfg.input_ch]
    input_views = x[..., cfg.input_ch: cfg.input_ch + cfg.input_ch_views]

    def dense(name, h):
        return F.linear(h, local[name + ".weight"], local[name + ".bias"])

    def gathered(name, z, width):
        return _gather_cols(z, groups) if _shardable(_layer(name), "weight", width, t) else z

    h = input_pts
    for i in range(cfg.D):
        h = gathered("pts_linears", F.relu(dense(f"pts_linears.{i}", h)), cfg.W)
        if i in cfg.skips:
            h = torch.cat([input_pts, h], dim=-1)
    if cfg.use_viewdirs:
        alpha = dense("alpha_linear", h)
        feature = gathered("feature_linear", dense("feature_linear", h), cfg.W)
        h = torch.cat([feature, input_views], dim=-1)
        h = gathered("views_linears", F.relu(dense("views_linears.0", h)), max(cfg.W // 2, 1))
        rgb = dense("rgb_linear", h)
        return torch.cat([rgb, alpha], dim=-1)
    return dense("output_linear", h)


def make_tp_apply(groups: MeshGroups, cfg: NeRFConfig, data_axis: Optional[str] = None):
    """Build apply(params, pts [N, S, 3], viewdirs [N, 3] or None) -> raw
    [N, S, 4 | output_ch] with the MLP's width sharded over the model
    group. With ``data_axis`` (a 2-D mesh) the N points also split over the
    data group (padded to a multiple of its size by repeating the last)
    and the outputs gather back, so every rank returns the whole result.
    ``params`` is the replicated state dict or ``tp_shard_params``' layout."""

    @torch.no_grad()
    def apply(params: Params, pts: torch.Tensor, viewdirs: Optional[torch.Tensor]):
        local = _local(params, cfg, groups)
        split = data_axis is not None and groups.data_group is not None
        n = pts.shape[0]
        if split:
            D, d = groups.data_size, groups.data_rank
            m = -(-n // D)

            def part(a):
                if a is None:
                    return None
                pad = m * D - n
                if pad:
                    a = torch.cat([a, a[-1:].expand((pad,) + tuple(a.shape[1:]))])
                return a[d * m:(d + 1) * m]

            pts, viewdirs = part(pts), part(viewdirs)
        raw = _apply_mlp_tp(local, cfg, embed_inputs(cfg, pts, viewdirs), groups)
        if split:
            raw = _all_gather_rows(raw, groups.data_size, groups.data_group)[:n]
        return raw

    return apply
