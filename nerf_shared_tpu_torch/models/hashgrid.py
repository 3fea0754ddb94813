"""Multiresolution hash-grid NeRF (instant-NGP family) as a torch module.

Counterpart of ``nerf_shared_tpu/models/hashgrid.py``: L levels of feature
tables indexed by the voxel corner (directly on coarse levels, by NGP's
spatial hash on fine ones), trilinear weights, and a tiny decoder (a
1-hidden-layer sigma net -> [sigma, geo_feat], softplus density shifted so
the initial sigma is ``sigma_bias``; an rgb net on [geo_feat, PE(dirs)]).
The raw output convention is apply_nerf's (rgb logits, sigma), so every
render path takes it through ``render/renderer._apply_model``.

Every table access goes through ``ops/cuda/gather.table_gather``: kernel P1
forward, kernel P2 (the scatter-add into the table's gradient) backward.
Layouts as in the JAX package: "vertex" (one fused [L*T, F] table, 8 rows a
point-level: one gather of [P, L, 8] rows), "cell" (the cell's 8 corners
packed in one [8F] row: one gather of [P, L] rows) and "split" (cell rows in
one table per level, direct levels sized N^3: one gather per level). The
corner sum slices the packed row by static column ranges and adds the
corners in the JAX order, so features agree to fp32 rounding.
``hashgrid_indices`` returns the rows an encode gathers.

Hash arithmetic: JAX hashes in uint32 with wraparound. Here the products
are taken in int64 (coordinates <= 2048 and primes < 2^32 fit), XORed, and
masked with ``rows - 1``; rows being a power of two, the low bits are the
uint32 result's. Indices go to the kernels as int32, as in JAX.

Parameters live in the module (``tables`` a Parameter, or a ParameterList
for "split"; ``sigma_net`` and ``rgb_net`` Linear lists); the functional
forms take the flat ``params()`` mapping ('tables.0', 'sigma_net.1.weight',
...). ``hashgrid_params_from_jax`` carries a JAX parameter pytree over.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from nerf_shared_tpu_torch.models.nerf import linear_init_, params_tree_from_jax
from nerf_shared_tpu_torch.ops.cuda.gather import table_gather
from nerf_shared_tpu_torch.ops.embedding import EmbedderConfig, embed

_HASH_PRIMES = (1, 2654435761, 805459861)
# corner c of a cell at offset (c >> 2 & 1, c >> 1 & 1, c & 1): the order of
# np.meshgrid([0, 1] x 3, indexing="ij") in the JAX package
_CORNERS = tuple(((c >> 2) & 1, (c >> 1) & 1, c & 1) for c in range(8))


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    L: int = 16                 # resolution levels
    log2_T: int = 19            # per-level table size 2^log2_T
    F: int = 2                  # feature channels per level
    base_res: int = 16          # coarsest grid resolution
    max_res: int = 2048         # finest grid resolution
    hidden: int = 64            # decoder width
    geo_feat: int = 15          # geometry features handed to the rgb net
    rgb_depth: int = 3          # rgb decoder layers (>= 1, incl. output)
    use_viewdirs: bool = True
    multires_views: int = 4
    i_embed: int = 0
    aabb_min: tuple = (-4.5, -4.5, -4.5)
    aabb_max: tuple = (4.5, 4.5, 4.5)
    sigma_bias: float = 0.1     # initial softplus density
    layout: str = "vertex"      # "vertex" | "cell" | "split"

    @property
    def T(self) -> int:
        return 1 << self.log2_T

    @property
    def views_embedder(self) -> EmbedderConfig:
        return EmbedderConfig(multires=self.multires_views, i_embed=self.i_embed)

    @property
    def views_dim(self) -> int:
        return self.views_embedder.out_dim if self.use_viewdirs else 0

    @property
    def resolutions(self) -> Tuple[int, ...]:
        """N_l = floor(N_min * b^l), b = exp((ln N_max - ln N_min) / (L - 1))."""
        if self.L == 1:
            return (self.base_res,)
        b = math.exp((math.log(self.max_res) - math.log(self.base_res)) / (self.L - 1))
        return tuple(int(math.floor(self.base_res * b ** l)) for l in range(self.L))

    @property
    def level_hashed(self) -> Tuple[bool, ...]:
        """True for levels whose vertex (cell layouts: cell) count exceeds T."""
        if self.layout in ("cell", "split"):
            return tuple(n ** 3 > self.T for n in self.resolutions)
        return tuple((n + 1) ** 3 > self.T for n in self.resolutions)

    @property
    def row_width(self) -> int:
        """F per vertex row, 8F per packed cell row."""
        return self.F * (8 if self.layout in ("cell", "split") else 1)

    @property
    def level_table_rows(self) -> Tuple[int, ...]:
        """Per-level rows of the "split" layout: N^3 direct, T hashed."""
        return tuple(min(n ** 3, self.T) for n in self.resolutions)


def _check_layout(cfg: HashGridConfig):
    if cfg.layout not in ("vertex", "cell", "split"):
        raise ValueError(f"unknown hashgrid layout {cfg.layout!r} "
                         "(expected 'vertex', 'cell' or 'split')")


class HashGrid(nn.Module):
    """One hash-grid field. ``generator`` seeds the init: tables
    U(-1e-4, 1e-4), Linear layers torch's default, then the sigma output
    layer scaled by 1e-2 with a zero bias (so the initial sigma is
    ``sigma_bias`` everywhere)."""

    def __init__(self, cfg: HashGridConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_layout(cfg)
        self.cfg = cfg
        if cfg.layout == "split":
            self.tables = nn.ParameterList(
                [nn.Parameter(torch.zeros(rows, cfg.row_width, device=device))
                 for rows in cfg.level_table_rows])
        else:
            self.tables = nn.Parameter(
                torch.zeros(cfg.L * cfg.T, cfg.row_width, device=device))
        self.sigma_net = nn.ModuleList([
            nn.Linear(cfg.L * cfg.F, cfg.hidden, device=device),
            nn.Linear(cfg.hidden, 1 + cfg.geo_feat, device=device)])
        layers, d_in = [], cfg.geo_feat + cfg.views_dim
        for li in range(cfg.rgb_depth):
            d_out = 3 if li == cfg.rgb_depth - 1 else cfg.hidden
            layers.append(nn.Linear(d_in, d_out, device=device))
            d_in = cfg.hidden
        self.rgb_net = nn.ModuleList(layers)
        if generator is not None:
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        tables = self.tables if self.cfg.layout == "split" else [self.tables]
        for t in tables:
            t.copy_(torch.empty(t.shape).uniform_(-1e-4, 1e-4, generator=generator))
        for m in (*self.sigma_net, *self.rgb_net):
            linear_init_(m, generator)
        self.sigma_net[1].weight.mul_(0.01)
        self.sigma_net[1].bias.zero_()

    def params(self):
        return dict(self.named_parameters())

    def forward(self, pts, viewdirs=None):
        return apply_hashgrid(self.params(), self.cfg, pts, viewdirs)


def _hash(c0, c1, c2, rows: int) -> torch.Tensor:
    """NGP's (x p0 ^ y p1 ^ z p2) mod rows on int64 coordinates -> int32."""
    h = (c0 * _HASH_PRIMES[0]) ^ (c1 * _HASH_PRIMES[1]) ^ (c2 * _HASH_PRIMES[2])
    return (h & (rows - 1)).to(torch.int32)


def _level_index(cfg: HashGridConfig, l: int, c, n: int, rows: int) -> torch.Tensor:
    """int32 table row of integer coordinates c [..., 3] (int64) on level
    l: the direct index with ``n`` cells (or vertices) a side, or the hash."""
    if cfg.level_hashed[l]:
        return _hash(c[..., 0], c[..., 1], c[..., 2], rows)
    return (c[..., 0] + c[..., 1] * n + c[..., 2] * (n * n)).to(torch.int32)


def _level_cells(cfg: HashGridConfig, x: torch.Tensor):
    """Per level of points x [P, 3]: (resolution n, cell x0 [P, 3] int32,
    fraction within the cell [P, 3]); edge-clamped outside the AABB."""
    lo = torch.tensor(cfg.aabb_min, dtype=x.dtype, device=x.device)
    hi = torch.tensor(cfg.aabb_max, dtype=x.dtype, device=x.device)
    u = (x - lo) / (hi - lo)                                   # [P, 3]
    cells = []
    for n in cfg.resolutions:
        xs = u * float(n)
        x0 = torch.clamp(torch.floor(xs).to(torch.int32), 0, n - 1)
        cells.append((n, x0, torch.clamp(xs - x0.to(x.dtype), 0.0, 1.0)))
    return cells


def _corner_offsets(device) -> torch.Tensor:
    # made once an encode: each host-to-device copy syncs the stream
    return torch.tensor(_CORNERS, dtype=torch.int64, device=device)  # [8, 3]


def _indices(cfg: HashGridConfig, cells, off: torch.Tensor):
    """int32 table rows of each level's cells: [P] per level ("split", into
    the level's own table), or [P, L] ("cell") / [P, L, 8] ("vertex") into
    the fused [L*T, w] table; ``off`` the [8, 3] corner offsets."""
    parts = []
    for l, (n, x0, _) in enumerate(cells):
        c = x0.to(torch.int64)
        if cfg.layout == "split":
            parts.append(_level_index(cfg, l, c, n, cfg.level_table_rows[l]))
        elif cfg.layout == "cell":
            parts.append(_level_index(cfg, l, c, n, cfg.T) + l * cfg.T)
        else:
            corners = c[:, None, :] + off                    # [P, 8, 3] in [0, N]
            parts.append(_level_index(cfg, l, corners, n + 1, cfg.T) + l * cfg.T)
    return parts if cfg.layout == "split" else torch.stack(parts, 1)


def hashgrid_indices(cfg: HashGridConfig, pts: torch.Tensor):
    """The table rows the encode of pts [..., 3] gathers, as int32 over the
    P flattened points: a list of L [P] tensors ("split"), or one [P, L]
    ("cell") or [P, L, 8] ("vertex") tensor into the fused table."""
    _check_layout(cfg)
    return _indices(cfg, _level_cells(cfg, pts.reshape(-1, 3)), _corner_offsets(pts.device))


def hashgrid_features(params: Mapping[str, torch.Tensor], cfg: HashGridConfig,
                      pts: torch.Tensor) -> torch.Tensor:
    """pts [..., 3] -> concatenated per-level features [..., L*F],
    edge-clamped outside the AABB."""
    _check_layout(cfg)
    lead = pts.shape[:-1]
    x = pts.reshape(-1, 3)
    cells = _level_cells(cfg, x)
    off = _corner_offsets(x.device)
    offf = off.to(x.dtype)
    weights = []
    for _, _, frac in cells:
        t = offf * frac[:, None, :] + (1.0 - offf) * (1.0 - frac[:, None, :])
        weights.append(t[..., 0] * t[..., 1] * t[..., 2])    # [P, 8]
    idx = _indices(cfg, cells, off)

    Fc = cfg.F
    feats = []
    if cfg.layout == "split":
        for l in range(cfg.L):
            g = table_gather(params[f"tables.{l}"], idx[l])                # [P, 8F]
            feats.append(sum(g[:, c * Fc:(c + 1) * Fc] * weights[l][:, c:c + 1]
                             for c in range(8)))
    else:
        # one gather over the fused table for every level, as in JAX
        g = table_gather(params["tables"], idx)                        # [P, L, (8,) w]
        for l in range(cfg.L):
            if cfg.layout == "cell":
                feats.append(sum(g[:, l, c * Fc:(c + 1) * Fc] * weights[l][:, c:c + 1]
                                 for c in range(8)))
            else:
                feats.append(torch.sum(g[:, l] * weights[l][..., None], dim=1))
    feat = torch.stack(feats, dim=1)                                     # [P, L, F]
    return feat.reshape(*lead, cfg.L * Fc)


def _sigma_shift(cfg: HashGridConfig) -> float:
    """Pre-activation shift so the initial sigma is sigma_bias:
    inverse-softplus for a positive bias, the bias itself otherwise."""
    if cfg.sigma_bias > 0:
        return math.log(math.expm1(cfg.sigma_bias))
    return cfg.sigma_bias


def _sigma_geo(params, cfg: HashGridConfig, feat: torch.Tensor):
    """Encoded features -> (softplus sigma [..., 1], geo features)."""
    h = F.relu(F.linear(feat, params["sigma_net.0.weight"], params["sigma_net.0.bias"]))
    out = F.linear(h, params["sigma_net.1.weight"], params["sigma_net.1.bias"])
    sigma = F.softplus(out[..., :1] + _sigma_shift(cfg))
    return sigma, out[..., 1:]


def apply_hashgrid(params, cfg: HashGridConfig, pts: torch.Tensor,
                   viewdirs: Optional[torch.Tensor]) -> torch.Tensor:
    """pts [..., S, 3] (+ dirs [..., 3]) -> raw [..., S, 4]: rgb logits and
    the (non-negative) density."""
    feat = hashgrid_features(params, cfg, pts)
    sigma, h = _sigma_geo(params, cfg, feat)
    if cfg.use_viewdirs and viewdirs is not None:
        dirs = viewdirs[..., None, :].expand(pts.shape)
        h = torch.cat([h, embed(dirs, cfg.views_embedder)], dim=-1)
    for li in range(cfg.rgb_depth):
        h = F.linear(h, params[f"rgb_net.{li}.weight"], params[f"rgb_net.{li}.bias"])
        if li < cfg.rgb_depth - 1:
            h = F.relu(h)
    return torch.cat([h, sigma], dim=-1)


def get_density(params, cfg: HashGridConfig, points: torch.Tensor) -> torch.Tensor:
    """Sigma alone at points [..., 3] -> [...]."""
    sigma, _ = _sigma_geo(params, cfg, hashgrid_features(params, cfg, points))
    return sigma[..., 0]


def hashgrid_params_from_jax(tree):
    """The JAX package's hashgrid pytree (numpy leaves) -> this module's
    state dict ('tables' or 'tables.<l>', 'sigma_net.<i>.weight' [out, in],
    ...)."""
    return params_tree_from_jax(tree)
