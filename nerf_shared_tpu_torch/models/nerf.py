"""The NeRF MLP as a torch ``nn.Module`` plus a plain functional forward.

Counterpart of ``nerf_shared_tpu/models/nerf.py`` (reference
nerf_shared/nerf.py:61-134): D layers of width W with ReLU, the embedded
points concatenated back in after each layer in ``skips``, and either the
viewdir head (alpha_linear W->1, feature_linear W->W, one views_linears layer
(W+dirs)->W//2, rgb_linear W//2->3) or a single output_linear W->output_ch.

The attribute names are the reference's, so a ``.tar`` written by the JAX
package (``utils/checkpoints.params_to_state_dict``) loads with
``load_state_dict(strict=True)``. ``apply_nerf`` is the plain forward on a
name -> tensor mapping (the module's own parameters, or any state dict);
``params_from_jax`` carries the JAX package's weight pytree over.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from nerf_shared_tpu_torch.ops.embedding import EmbedderConfig, embed

Params = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    D: int = 8
    W: int = 256
    output_ch: int = 4          # only used when use_viewdirs=False
    skips: tuple = (4,)
    use_viewdirs: bool = True
    multires: int = 10
    multires_views: int = 4
    i_embed: int = 0

    @property
    def pts_embedder(self) -> EmbedderConfig:
        return EmbedderConfig(multires=self.multires, i_embed=self.i_embed)

    @property
    def views_embedder(self) -> EmbedderConfig:
        return EmbedderConfig(multires=self.multires_views, i_embed=self.i_embed)

    @property
    def input_ch(self) -> int:
        return self.pts_embedder.out_dim

    @property
    def input_ch_views(self) -> int:
        return self.views_embedder.out_dim if self.use_viewdirs else 0

    def layer_in(self, i: int) -> int:
        """Input width of pts_linears[i] (skip layers take [pts, h])."""
        if i == 0:
            return self.input_ch
        return self.W + self.input_ch if (i - 1) in self.skips else self.W


class NeRF(nn.Module):
    """One NeRF MLP. ``generator`` seeds the torch.nn.Linear-style init
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights and biases."""

    def __init__(self, cfg: NeRFConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        W = cfg.W

        def lin(i, o):
            return nn.Linear(i, o, device=device)

        self.pts_linears = nn.ModuleList(
            [lin(cfg.layer_in(i), W) for i in range(cfg.D)])
        if cfg.use_viewdirs:
            self.views_linears = nn.ModuleList(
                [lin(cfg.input_ch_views + W, W // 2)])
            self.feature_linear = lin(W, W)
            self.alpha_linear = lin(W, 1)
            self.rgb_linear = lin(W // 2, 3)
        else:
            self.output_linear = lin(W, cfg.output_ch)
        if generator is not None:
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        for m in self.modules():
            if isinstance(m, nn.Linear):
                linear_init_(m, generator)

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters())

    def forward(self, pts, viewdirs=None):
        return apply_nerf(self.params(), self.cfg, pts, viewdirs)


@torch.no_grad()
def linear_init_(m: nn.Linear, generator: torch.Generator):
    """torch.nn.Linear's default init from ``generator``: weight and bias
    ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)), drawn on the CPU."""
    bound = 1.0 / math.sqrt(m.in_features)
    for p in (m.weight, m.bias):
        p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))


def _dense(params: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, params[name + ".weight"], params[name + ".bias"])


def apply_mlp(params: Params, cfg: NeRFConfig, x: torch.Tensor) -> torch.Tensor:
    """The MLP on pre-embedded features [..., input_ch (+ input_ch_views)]
    (reference nerf.py:110-134)."""
    input_pts = x[..., : cfg.input_ch]
    input_views = x[..., cfg.input_ch: cfg.input_ch + cfg.input_ch_views]
    h = input_pts
    for i in range(cfg.D):
        h = F.relu(_dense(params, f"pts_linears.{i}", h))
        if i in cfg.skips:
            h = torch.cat([input_pts, h], dim=-1)
    if cfg.use_viewdirs:
        alpha = _dense(params, "alpha_linear", h)
        feature = _dense(params, "feature_linear", h)
        h = torch.cat([feature, input_views], dim=-1)
        h = F.relu(_dense(params, "views_linears.0", h))
        rgb = _dense(params, "rgb_linear", h)
        return torch.cat([rgb, alpha], dim=-1)
    return _dense(params, "output_linear", h)


def apply_nerf(params: Params, cfg: NeRFConfig, pts: torch.Tensor,
               viewdirs: Optional[torch.Tensor]) -> torch.Tensor:
    """Embed points [..., S, 3] (+ dirs [..., 3]) and run the MLP in fp32
    -> raw [..., S, 4 | output_ch]."""
    emb = embed(pts, cfg.pts_embedder)
    if viewdirs is not None:
        dirs = viewdirs[..., None, :].expand(pts.shape)
        emb = torch.cat([emb, embed(dirs, cfg.views_embedder)], dim=-1)
    return apply_mlp(params, cfg, emb)


def torch_param_order(cfg: NeRFConfig) -> list:
    """State-dict names in the reference module's attribute order
    (reference nerf.py:79-94)."""
    order = []
    for i in range(cfg.D):
        order += [f"pts_linears.{i}.weight", f"pts_linears.{i}.bias"]
    if cfg.use_viewdirs:
        order += ["views_linears.0.weight", "views_linears.0.bias",
                  "feature_linear.weight", "feature_linear.bias",
                  "alpha_linear.weight", "alpha_linear.bias",
                  "rgb_linear.weight", "rgb_linear.bias"]
    else:
        order += ["output_linear.weight", "output_linear.bias"]
    return order


def params_from_jax(params) -> "collections.OrderedDict[str, torch.Tensor]":
    """The JAX package's weight pytree (numpy arrays, weights [in, out],
    ``{"pts_linears": [{"w", "b"}, ...], "alpha_linear": {...}, ...}``) ->
    this package's state dict (weights [out, in]), in module order."""
    sd = collections.OrderedDict()

    def put(name, p):
        sd[name + ".weight"] = torch.from_numpy(
            np.array(np.asarray(p["w"], np.float32).T, order="C"))
        sd[name + ".bias"] = torch.from_numpy(
            np.array(np.asarray(p["b"], np.float32), order="C"))

    for i, p in enumerate(params["pts_linears"]):
        put(f"pts_linears.{i}", p)
    if "views_linears" in params:
        for i, p in enumerate(params["views_linears"]):
            put(f"views_linears.{i}", p)
        for name in ("feature_linear", "alpha_linear", "rgb_linear"):
            put(name, params[name])
    else:
        put("output_linear", params["output_linear"])
    return sd


def params_tree_from_jax(tree) -> "collections.OrderedDict[str, torch.Tensor]":
    """A JAX parameter pytree of nested dicts and lists (numpy leaves;
    ``{"w": [in, out], "b": [out]}`` pairs are dense layers) -> a state
    dict with dotted names ('rgb.0.weight', 'tables.3', 'planes') and
    weights transposed to [out, in]. The grid families' converter."""
    sd = collections.OrderedDict()

    def walk(node, prefix):
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for k, v in items:
            name = f"{prefix}{k}"
            if isinstance(v, dict) and set(v) == {"w", "b"}:
                sd[name + ".weight"] = torch.from_numpy(
                    np.array(np.asarray(v["w"], np.float32).T, order="C"))
                sd[name + ".bias"] = torch.from_numpy(
                    np.array(np.asarray(v["b"], np.float32), order="C"))
            elif isinstance(v, (dict, list, tuple)):
                walk(v, name + ".")
            else:
                sd[name] = torch.from_numpy(np.array(np.asarray(v, np.float32), order="C"))

    walk(tree, "")
    return sd
