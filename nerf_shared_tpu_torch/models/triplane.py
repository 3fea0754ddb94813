"""Triplane NeRF as a torch module.

Counterpart of ``nerf_shared_tpu/models/triplane.py``: three axis-aligned
feature planes (xy, xz, yz) whose bilinear samples are summed into C
features, a linear sigma head (+ ``sigma_bias``) and an rgb decoder on
[features, PE(dirs)]. Raw outputs follow apply_nerf's convention.

The planes [3, G, G, W] are read as one [3·G·G, W] table through
``ops/cuda/gather.table_gather`` (kernel P1 forward, P2 backward), with each
plane's rows offset by p·G·G. Layouts: "vertex" (shared corners, W = C: four
gathers a plane, twelve a point, with ``mode="clip"`` semantics and the
corner cell clamped to [0, G-2]) and "cell" (the 4 corners packed in one
[4C] row: one gather a plane, the cell clamped to [0, G-1]).
``upsample_triplane`` grows the planes (both layouts, plain torch);
``triplane_indices`` returns the rows an encode gathers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from nerf_shared_tpu_torch.models.nerf import linear_init_, params_tree_from_jax
from nerf_shared_tpu_torch.ops.cuda.gather import table_gather
from nerf_shared_tpu_torch.ops.embedding import EmbedderConfig, embed


@dataclasses.dataclass(frozen=True)
class TriplaneConfig:
    G: int = 256                # plane resolution
    C: int = 16                 # feature channels per plane (summed)
    hidden: int = 64            # rgb decoder width
    depth: int = 2              # rgb decoder layers (>= 1)
    use_viewdirs: bool = True
    multires_views: int = 4
    i_embed: int = 0
    aabb_min: tuple = (-4.5, -4.5, -4.5)
    aabb_max: tuple = (4.5, 4.5, 4.5)
    sigma_bias: float = 0.1
    layout: str = "vertex"      # "vertex" | "cell"

    @property
    def views_embedder(self) -> EmbedderConfig:
        return EmbedderConfig(multires=self.multires_views, i_embed=self.i_embed)

    @property
    def views_dim(self) -> int:
        return self.views_embedder.out_dim if self.use_viewdirs else 0

    @property
    def width(self) -> int:
        """Plane row width: C per vertex, 4C per packed cell."""
        return self.C * (4 if self.layout == "cell" else 1)


class Triplane(nn.Module):
    """One triplane field. ``generator`` seeds the init: planes 0.05·N(0, 1),
    Linear layers torch's default."""

    def __init__(self, cfg: TriplaneConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.layout not in ("vertex", "cell"):
            raise ValueError(f"unknown triplane layout {cfg.layout!r} "
                             "(expected 'vertex' or 'cell')")
        self.cfg = cfg
        self.planes = nn.Parameter(torch.zeros(3, cfg.G, cfg.G, cfg.width, device=device))
        self.sigma = nn.Linear(cfg.C, 1, device=device)
        layers, d_in = [], cfg.C + cfg.views_dim
        for li in range(cfg.depth):
            d_out = 3 if li == cfg.depth - 1 else cfg.hidden
            layers.append(nn.Linear(d_in, d_out, device=device))
            d_in = cfg.hidden
        self.rgb = nn.ModuleList(layers)
        if generator is not None:
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        self.planes.copy_(0.05 * torch.randn(self.planes.shape, generator=generator))
        for m in (self.sigma, *self.rgb):
            linear_init_(m, generator)

    def params(self):
        return dict(self.named_parameters())

    def forward(self, pts, viewdirs=None):
        return apply_triplane(self.params(), self.cfg, pts, viewdirs)


_PLANES = ((0, 1), (0, 2), (1, 2))   # the xy, xz and yz planes' axes


def _plane_coords(cfg: TriplaneConfig, pts: torch.Tensor) -> torch.Tensor:
    """pts [..., 3] -> plane coordinates [..., 3]: cell-grid coordinates
    in [0, G) for "cell", cell-center coordinates for "vertex"."""
    lo = torch.tensor(cfg.aabb_min, dtype=pts.dtype, device=pts.device)
    hi = torch.tensor(cfg.aabb_max, dtype=pts.dtype, device=pts.device)
    u = (pts - lo) / (hi - lo) * cfg.G
    return u if cfg.layout == "cell" else u - 0.5


def _vertex_cell(G: int, a, b):
    """Corner cell (a0, b0) int32, clamped to [0, G-2], and the fractions
    [..., 1] of cell-center coords (a, b) clamped into [0, G-1]."""
    a = torch.clamp(a, 0.0, G - 1.0)
    b = torch.clamp(b, 0.0, G - 1.0)
    a0 = torch.clamp(torch.floor(a).to(torch.int32), 0, G - 2)
    b0 = torch.clamp(torch.floor(b).to(torch.int32), 0, G - 2)
    return a0, b0, (a - a0.to(a.dtype))[..., None], (b - b0.to(b.dtype))[..., None]


def _vertex_rows(p: int, G: int, a0, b0):
    """int32 rows of corners 00, 01, 10, 11 of cell (a0, b0) in plane p
    (rows p·G·G.. of the [3·G·G, C] table), each clipped into the plane
    (``jnp.take(..., mode="clip")``)."""
    base = a0 * G + b0
    return tuple(torch.clamp(i, 0, G * G - 1) + p * G * G
                 for i in (base, base + 1, base + G, base + G + 1))


def _packed_cell(G: int, a, b):
    """Cell (a0, b0) int32 of cell-grid coords (a, b), clamped to [0, G-1],
    and the fractions [..., 1] within it."""
    a0 = torch.clamp(torch.floor(a).to(torch.int32), 0, G - 1)
    b0 = torch.clamp(torch.floor(b).to(torch.int32), 0, G - 1)
    fa = torch.clamp(a - a0.to(a.dtype), 0.0, 1.0)[..., None]
    fb = torch.clamp(b - b0.to(b.dtype), 0.0, 1.0)[..., None]
    return a0, b0, fa, fb


def _sample_plane(table, p: int, G: int, a, b):
    """Bilinear sample of plane p at cell-center coords (a, b): four
    gathers."""
    a0, b0, fa, fb = _vertex_cell(G, a, b)
    p00, p01, p10, p11 = (table_gather(table, i) for i in _vertex_rows(p, G, a0, b0))
    top = p00 * (1 - fb) + p01 * fb
    bot = p10 * (1 - fb) + p11 * fb
    return top * (1 - fa) + bot * fa


def _sample_plane_packed(table, p: int, G: int, C: int, a, b):
    """Bilinear sample of packed plane p at cell-grid coords (a, b) in
    [0, G): one gather of the cell's [4C] row (corner slots 00, 01, 10, 11)."""
    a0, b0, fa, fb = _packed_cell(G, a, b)
    g = table_gather(table, a0 * G + b0 + p * G * G)          # [..., 4C]
    top = g[..., 0 * C:1 * C] * (1 - fb) + g[..., 1 * C:2 * C] * fb
    bot = g[..., 2 * C:3 * C] * (1 - fb) + g[..., 3 * C:4 * C] * fb
    return top * (1 - fa) + bot * fa


def triplane_indices(cfg: TriplaneConfig, pts: torch.Tensor) -> torch.Tensor:
    """The table rows the encode of pts [..., 3] gathers, int32: [3, 4,
    ...] for "vertex" (planes xy, xz, yz; corners 00, 01, 10, 11), [3, ...]
    for "cell", into the [3·G·G, width] table."""
    G, u = cfg.G, _plane_coords(cfg, pts)
    if cfg.layout == "cell":
        return torch.stack([a0 * G + b0 + p * G * G for p, (a0, b0, _, _) in enumerate(
            _packed_cell(G, u[..., i], u[..., j]) for i, j in _PLANES)])
    return torch.stack([torch.stack(_vertex_rows(p, G, *_vertex_cell(G, u[..., i], u[..., j])[:2]))
                        for p, (i, j) in enumerate(_PLANES)])


def triplane_features(params, cfg: TriplaneConfig, pts: torch.Tensor) -> torch.Tensor:
    """pts [..., 3] -> summed plane features [..., C], edge-clamped
    outside the AABB."""
    G = cfg.G
    table = params["planes"].reshape(3 * G * G, cfg.width)
    u = _plane_coords(cfg, pts)
    f = None
    for p, (i, j) in enumerate(_PLANES):
        if cfg.layout == "cell":
            s = _sample_plane_packed(table, p, G, cfg.C, u[..., i], u[..., j])
        else:
            s = _sample_plane(table, p, G, u[..., i], u[..., j])
        f = s if f is None else f + s
    return f


def apply_triplane(params, cfg: TriplaneConfig, pts: torch.Tensor,
                   viewdirs: Optional[torch.Tensor]) -> torch.Tensor:
    """pts [..., S, 3] (+ dirs [..., 3]) -> raw [..., S, 4]: rgb logits and
    pre-relu sigma."""
    feat = triplane_features(params, cfg, pts)
    sigma = F.linear(feat, params["sigma.weight"], params["sigma.bias"]) + cfg.sigma_bias
    h = feat
    if cfg.use_viewdirs and viewdirs is not None:
        dirs = viewdirs[..., None, :].expand(pts.shape)
        h = torch.cat([h, embed(dirs, cfg.views_embedder)], dim=-1)
    for li in range(cfg.depth):
        h = F.linear(h, params[f"rgb.{li}.weight"], params[f"rgb.{li}.bias"])
        if li < cfg.depth - 1:
            h = F.relu(h)
    return torch.cat([h, sigma], dim=-1)


def get_density(params, cfg: TriplaneConfig, points: torch.Tensor) -> torch.Tensor:
    """Pre-relu sigma alone at points [..., 3] -> [...]."""
    feat = triplane_features(params, cfg, points)
    return (F.linear(feat, params["sigma.weight"], params["sigma.bias"])
            + cfg.sigma_bias)[..., 0]


def _resize_w(n_old: int, n_new: int, dtype, device) -> torch.Tensor:
    """Align-corners bilinear weights [n_new, n_old]: new vertex j sits at
    old lattice coordinate j (n_old - 1) / (n_new - 1)."""
    t = torch.linspace(0.0, n_old - 1.0, n_new, dtype=dtype, device=device)
    i0 = torch.clamp(torch.floor(t).long(), 0, n_old - 2)
    f = t - i0.to(dtype)
    w = torch.zeros((n_new, n_old), dtype=dtype, device=device)
    rows = torch.arange(n_new, device=device)
    w.index_put_((rows, i0), 1.0 - f, accumulate=True)
    w.index_put_((rows, i0 + 1), f, accumulate=True)
    return w


def _upsample_packed(plane: torch.Tensor, G: int, C: int, new_G: int) -> torch.Tensor:
    """One packed [G, G, 4C] plane -> [new_G, new_G, 4C]: unpack the slots
    onto the (G+1)^2 vertex grid (duplicated corners averaged), resize it
    with align-corners bilinear weights, repack each new cell's corners."""
    v = plane.new_zeros((G + 1, G + 1, C))
    n = plane.new_zeros((G + 1, G + 1, 1))
    one = plane.new_ones((G, G, 1))
    for k, (i, j) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        v[i:i + G, j:j + G] += plane[..., k * C:(k + 1) * C]
        n[i:i + G, j:j + G] += one
    v = v / n
    w = _resize_w(G + 1, new_G + 1, plane.dtype, plane.device)
    v2 = torch.einsum("ai,ijc,bj->abc", w, v, w)
    return torch.cat([v2[:new_G, :new_G], v2[:new_G, 1:], v2[1:, :new_G], v2[1:, 1:]],
                     dim=-1)


@torch.no_grad()
def upsample_triplane(params, cfg: TriplaneConfig, new_G: int):
    """Coarse-to-fine plane growth -> (params with new planes, cfg with
    G = new_G); the decoder carries over. Vertex planes resize bilinearly
    with half-pixel centers (``jax.image.resize(..., "linear")`` when
    growing); packed planes go through the shared-vertex grid
    (``_upsample_packed``). The caller rebuilds the modules and restarts
    Adam (train/state.fresh_state_at)."""
    planes = params["planes"]
    if cfg.layout == "cell":
        new = torch.stack([_upsample_packed(planes[p], cfg.G, cfg.C, new_G)
                           for p in range(3)])
    else:
        new = F.interpolate(planes.permute(0, 3, 1, 2), size=(new_G, new_G),
                            mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    out = {k: v.detach() for k, v in params.items()}
    out["planes"] = new.contiguous()
    return out, dataclasses.replace(cfg, G=new_G)


def triplane_params_from_jax(tree):
    """The JAX package's triplane pytree (numpy leaves) -> this module's
    state dict ('planes', 'sigma.weight' [out, in], 'rgb.<i>.weight', ...)."""
    return params_tree_from_jax(tree)
