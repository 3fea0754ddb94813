"""The NeRF MLP as a torch ``nn.Module`` plus a plain functional forward.

Counterpart of ``nerf_shared_tpu/models/nerf.py`` (reference
nerf_shared/nerf.py:61-134): D layers of width W with ReLU, the embedded
points concatenated back in after each layer in ``skips``, and either the
viewdir head (alpha_linear W->1, feature_linear W->W, one views_linears layer
(W+dirs)->W//2, rgb_linear W//2->3) or a single output_linear W->output_ch.

``MipNeRFConfig`` is mip-NeRF's network (Barron et al., ICCV 2021;
``--model_type mipnerf``): the same layers, its points Gaussians (the
[..., 6] records of ops/mip.py) encoded by the integrated positional
encoding at frequencies 2^l, l in [min_deg_point, multires), with no
identity columns; ``density_bias`` and ``rgb_padding`` are its output
activations, which its interval composite applies
(ops/compositing.composite_intervals).

The attribute names are the reference's, so a ``.tar`` written by the JAX
package (``utils/checkpoints.params_to_state_dict``) loads with
``load_state_dict(strict=True)``. ``apply_nerf`` is the plain forward on a
name -> tensor mapping (the module's own parameters, or any state dict);
``params_from_jax`` carries the JAX package's weight pytree over.
``anneal_nerf_params`` is BARF's coarse-to-fine annealing of the encoding,
applied to the weights that read each encoded channel.
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
from nerf_shared_tpu_torch.ops.mip import ipe

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
    def ipe(self) -> bool:
        """Points are Gaussians through the integrated encoding
        (``MipNeRFConfig``)."""
        return False

    @property
    def point_width(self) -> int:
        """Floats a point takes: 3, or the Gaussian record's 6 under IPE."""
        return 6 if self.ipe else 3

    @property
    def pts_embedder(self) -> EmbedderConfig:
        return EmbedderConfig(multires=self.multires, i_embed=self.i_embed)

    @property
    def views_embedder(self) -> EmbedderConfig:
        return EmbedderConfig(multires=self.multires_views, i_embed=self.i_embed)

    @property
    def input_ch(self) -> int:
        if self.ipe:
            return 6 * (self.multires - self.min_deg_point)
        return self.pts_embedder.out_dim

    @property
    def input_ch_views(self) -> int:
        return self.views_embedder.out_dim if self.use_viewdirs else 0

    def layer_in(self, i: int) -> int:
        """Input width of pts_linears[i] (skip layers take [pts, h])."""
        if i == 0:
            return self.input_ch
        return self.W + self.input_ch if (i - 1) in self.skips else self.W


@dataclasses.dataclass(frozen=True)
class MipNeRFConfig(NeRFConfig):
    """mip-NeRF's network (module docstring) and the constants of its
    published Blender recipe (``configs/blender.gin``): ``multires`` is its
    max_deg_point, ``multires_views`` its deg_view; its output activations
    are softplus(sigma + density_bias) and sigmoid(rgb) * (1 + 2
    rgb_padding) - rgb_padding; the fine edges are drawn from the blurred
    coarse weights plus ``resample_padding``; the coarse MSE weighs
    ``coarse_loss_mult``."""

    multires: int = 16
    min_deg_point = 0
    density_bias = -1.0
    rgb_padding = 0.001
    resample_padding = 0.01
    coarse_loss_mult = 0.1

    @property
    def ipe(self) -> bool:
        return True


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
    w, b = params[name + ".weight"], params[name + ".bias"]
    if x.dtype == torch.float32:
        return F.linear(x, w, b)
    # below fp32, the product and the bias add each round to x's type, as
    # the JAX package's x @ w + b does
    return torch.matmul(x, w.t()) + b


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


def embed_inputs(cfg: NeRFConfig, pts: torch.Tensor,
                 viewdirs: Optional[torch.Tensor]) -> torch.Tensor:
    """[γ(pts), γ(dirs)] [..., S, input_ch (+ input_ch_views)] in fp32, the
    directions [..., 3] broadcast over the S samples of each ray. Under
    IPE ``pts`` are Gaussian records [..., S, 6] and γ is their IPE."""
    if cfg.ipe:
        emb = ipe(pts[..., :3], pts[..., 3:], cfg.min_deg_point, cfg.multires)
    else:
        emb = embed(pts, cfg.pts_embedder)
    if viewdirs is not None:
        dirs = viewdirs[..., None, :].expand(pts.shape[:-1] + (3,))
        emb = torch.cat([emb, embed(dirs, cfg.views_embedder)], dim=-1)
    return emb


def apply_nerf(params: Params, cfg: NeRFConfig, pts: torch.Tensor,
               viewdirs: Optional[torch.Tensor],
               compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Embed points [..., S, 3] (+ dirs [..., 3]) and run the MLP ->
    raw [..., S, 4 | output_ch] fp32. Under ``compute_dtype`` bfloat16 the
    encoder runs in fp32 and everything after it in bf16, as the JAX
    package's ``apply_nerf(..., compute_dtype)`` runs it: the weights AND
    biases and the embedding are cast, and every layer's product and bias
    add round to bf16. The parameters stay fp32; only the compute casts."""
    emb = embed_inputs(cfg, pts, viewdirs)
    if compute_dtype == torch.float32:
        return apply_mlp(params, cfg, emb)
    cast = {k: params[k].to(compute_dtype) for k in torch_param_order(cfg)}
    return apply_mlp(cast, cfg, emb.to(compute_dtype)).float()


def barf_freq_weights(progress, n_freqs: int) -> torch.Tensor:
    """BARF coarse-to-fine frequency weights (Lin et al. 2021, eq. 14):
    alpha = progress * n_freqs; band k gets 0 while alpha < k, a raised
    cosine on alpha in [k, k + 1], and 1 after. ``progress`` is a float or
    a float32 tensor in [0, 1]; the weights are float32 on the CPU."""
    k = torch.arange(n_freqs, dtype=torch.float32)
    alpha = torch.as_tensor(progress * n_freqs, dtype=torch.float32).cpu()
    x = torch.clamp(alpha - k, 0.0, 1.0)
    return 0.5 * (1.0 - torch.cos(math.pi * x))


def _anneal_channel_mask(ecfg: EmbedderConfig, progress) -> Optional[torch.Tensor]:
    """Per-channel weights over embed's layout ([x, then sin / cos blocks
    frequency-major]), or None when there is nothing to anneal (identity
    embedding, no frequencies)."""
    if ecfg.i_embed == -1 or ecfg.multires <= 0:
        return None
    per = torch.repeat_interleave(barf_freq_weights(progress, ecfg.multires),
                                  2 * ecfg.input_dims)
    if ecfg.include_input:
        per = torch.cat([torch.ones(ecfg.input_dims), per])
    return per


def anneal_nerf_params(params: Params, cfg: NeRFConfig, progress) -> Dict[str, torch.Tensor]:
    """BARF annealing in parameter space: the weights that read encoded
    channel i are scaled by its mask m_i, which equals masking the
    encoding, (γ(x)∘m)·Wᵀ = γ(x)·(W∘m)ᵀ, forward and backward (the stored
    weights' gradient carries the same m_i, so masked bands get none). So
    the kernels B1 / B2 / B3 anneal without any change.

    Weights are [out, in] here (the JAX package's are [in, out]), so the
    mask scales COLUMNS: of pts_linears.0, of the input-point columns of
    every skip successor (its input is [input_pts, h]) and of the direction
    columns of views_linears.0 (its input is [feature, γ(dirs)]). Returns a
    new name -> tensor dict; the other entries are the given tensors."""
    out = dict(params)

    def scale(name, mask):
        w = params[name]
        out[name] = w * mask.to(device=w.device, dtype=w.dtype)

    mp = _anneal_channel_mask(cfg.pts_embedder, progress)
    if mp is not None:
        scale("pts_linears.0.weight", mp)
        for i in cfg.skips:
            if i + 1 < cfg.D:
                rest = params[f"pts_linears.{i + 1}.weight"].shape[1] - mp.shape[0]
                scale(f"pts_linears.{i + 1}.weight", torch.cat([mp, torch.ones(rest)]))
    if cfg.use_viewdirs and "views_linears.0.weight" in params:
        mv = _anneal_channel_mask(cfg.views_embedder, progress)
        if mv is not None:
            rest = params["views_linears.0.weight"].shape[1] - mv.shape[0]
            scale("views_linears.0.weight", torch.cat([torch.ones(rest), mv]))
    return out


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
