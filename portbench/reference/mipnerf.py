"""Plain reference of mip-NeRF's training step on Blender scenes.

Written from the published description (Barron et al., "Mip-NeRF: A
Multiscale Representation for Anti-Aliasing Neural Radiance Fields", ICCV
2021) as google/mipnerf lays it out (``internal/mip.py``,
``internal/models.py`` MipNerfModel and MLP, ``configs/blender.gin``):

- each pixel casts a cone of base radius dx·2/sqrt(12), dx the distance
  between the unnormalised world directions of the pixel and the pixel one
  row below;
- a ray's samples are the intervals between N + 1 stratified edges on
  [near, far]; each conical frustum [t0, t1] is a Gaussian with the stable
  t_mean, t_var, r_var forms, lifted to the diagonal covariance
  t_var·d² + r_var·(1 - d²/|d|²);
- the points' integrated positional encoding at 2^l, l in [min_deg,
  max_deg): every sin(2^l μ)·exp(-4^l σ²/2), then every cosine, frequency-
  major and three coordinates a frequency, no identity; the directions'
  encoding [x, every sin(2^l x), every cos(2^l x)], l < deg_view;
- one MLP for both levels: depth x width with ReLU, the input appended
  after layer 4 ([h, input]), the density head, a bottleneck without
  activation, one view layer of width/2 on [bottleneck, direction
  encoding], the rgb head; density softplus(raw + density_bias), colour
  sigmoid(raw)·(1 + 2 pad) - pad;
- compositing over intervals (delta = (t1 - t0)·|d|, no sentinel), a white
  background; the fine edges resampled from the coarse weights (a 2-tap max
  and a 2-tap mean over the edge-padded weights, plus resample_padding)
  by the sorted piecewise-constant sampler, as many as the coarse pass
  has, under stop-gradient and not merged with the coarse edges;
- loss coarse_loss_mult·MSE(coarse) + MSE(fine); Adam (0.9, 0.999, 1e-8)
  at the log-linear rate from lr_init to lr_final over max_steps, times the
  delay that rises from lr_delay_mult to 1 along a quarter sine over
  lr_delay_steps, evaluated at step k + 1 for the update after k updates.

Departures from the source, each without effect on what is compared:

- the cosine column is cos(y), where the source writes sin(y + π/2);
- MSE is the mean over rays and channels; the source divides the squared
  error summed over the three channels by its ray mask's sum, three times
  that, which scales every gradient alike (Adam's update moves only through
  eps);
- softplus is ``torch.nn.functional.softplus`` (the source's
  log(1 + exp(x)); the two differ only above x = 20, where both are x in
  fp32);
- the resampler finds each u's interval by the mask of the source
  (u >= cdf), its maximum and minimum as written; the depth map is left
  out (nothing compared reads it);
- no weight decay (the Blender recipe's ``weight_decay_mult`` is 0).

Plain PyTorch in float32 with TF32 off (``no_tf32``). It imports nothing
of the measured program. The random draws follow the program's protocol so
that both sides see the same ones: a CPU ``torch.Generator`` per step
draws the pixels (one image, then the first N entries of a keyed Feistel
permutation of its pixels: ``feistel_index``, a frozen copy of the
program's) and the seed of a device generator, which draws the stratified
jitter and then the resampling positions.

Weights are held in the source's layout: ``kernel`` [in, out] and ``bias``
of each dense layer, under the source's roles (``dense_0`` ...
``dense_{depth-1}``, ``density``, ``bottleneck``, ``condition_0``,
``rgb``). ``to_program`` / ``from_program`` map them onto the program's
state dict (``pts_linears.i``, ``alpha_linear``, ``feature_linear``,
``views_linears.0``, ``rgb_linear``; weights [out, in]): each encoded
column moves to the program's place (``point_columns``,
``view_columns``: the program orders its encodings frequency-major with
the sines and cosines of one frequency together), and the layer after the
skip takes the program's input order [input, h].

The benchmark's copy of this file is portbench/reference/mipnerf.py; the
two are identical.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

M32 = 0xFFFFFFFF
EPS32 = float(torch.finfo(torch.float32).eps)
SKIP = 4


def no_tf32():
    """fp32 products in full fp32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ----------------------------------------------------------------- network

def point_width(net: dict) -> int:
    return 6 * (net["max_deg_point"] - net["min_deg_point"])


def view_width(net: dict) -> int:
    return 3 + 6 * net["deg_view"]


def param_shapes(net: dict) -> Dict[str, tuple]:
    """name -> shape of every leaf, the source's layout (kernels [in, out])."""
    D, W, P, V = net["depth"], net["width"], point_width(net), view_width(net)
    out = {}
    for i in range(D):
        fan_in = P if i == 0 else (W + P if i - 1 == SKIP else W)
        out[f"dense_{i}.kernel"], out[f"dense_{i}.bias"] = (fan_in, W), (W,)
    for name, (i, o) in (("density", (W, 1)), ("bottleneck", (W, W)),
                         ("condition_0", (W + V, W // 2)), ("rgb", (W // 2, 3))):
        out[f"{name}.kernel"], out[f"{name}.bias"] = (i, o), (o,)
    return out


def pos_enc(x: torch.Tensor, min_deg: int, max_deg: int, append_identity: bool):
    """The source's ``pos_enc``: [x,] every sin(2^l x), then every cos."""
    scales = torch.tensor([2.0 ** i for i in range(min_deg, max_deg)], device=x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(*x.shape[:-1], -1)
    feat = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-1)
    return torch.cat([x, feat], dim=-1) if append_identity else feat


def integrated_pos_enc(mean: torch.Tensor, var: torch.Tensor, min_deg: int, max_deg: int):
    """The source's ``integrated_pos_enc`` (diagonal): the expected sines
    exp(-y_var / 2)·sin(y), then the cosines, y = 2^l μ, y_var = 4^l σ²."""
    scales = torch.tensor([2.0 ** i for i in range(min_deg, max_deg)], device=mean.device)
    shape = (*mean.shape[:-1], -1)
    y = (mean[..., None, :] * scales[:, None]).reshape(shape)
    y_var = (var[..., None, :] * scales[:, None] ** 2).reshape(shape)
    att = torch.exp(-0.5 * y_var)
    return torch.cat([torch.sin(y) * att, torch.cos(y) * att], dim=-1)


def mlp(params: Dict[str, torch.Tensor], net: dict, x: torch.Tensor,
        condition: torch.Tensor):
    """(raw_rgb [..., 3], raw_density [..., 1]) of encoded points x [..., P]
    and encoded directions ``condition`` [..., V] (broadcast alike)."""
    def dense(name, h):
        return h @ params[name + ".kernel"] + params[name + ".bias"]

    inputs, h = x, x
    for i in range(net["depth"]):
        h = F.relu(dense(f"dense_{i}", h))
        if i % SKIP == 0 and i > 0:
            h = torch.cat([h, inputs], dim=-1)
    raw_density = dense("density", h)
    bottleneck = dense("bottleneck", h)
    h = F.relu(dense("condition_0", torch.cat([bottleneck, condition], dim=-1)))
    return dense("rgb", h), raw_density


# ---------------------------------------------------- the program's layout

def point_columns(net: dict) -> List[int]:
    """For each IPE column of the source, its column in the program's
    encoding (per frequency: its three sines, then its three cosines)."""
    n = net["max_deg_point"] - net["min_deg_point"]
    return [6 * l + 3 * c + d for c in (0, 1) for l in range(n) for d in range(3)]


def view_columns(net: dict) -> List[int]:
    """The same for the directions' encoding (the identity first in both)."""
    n = net["deg_view"]
    return [0, 1, 2] + [3 + 6 * l + 3 * c + d for c in (0, 1) for l in range(n)
                        for d in range(3)]


PROGRAM_NAMES = {"density": "alpha_linear", "bottleneck": "feature_linear",
                 "condition_0": "views_linears.0", "rgb": "rgb_linear"}


def program_name(name: str) -> str:
    """The program's state-dict name of a leaf of this file."""
    layer, kind = name.split(".")
    layer = PROGRAM_NAMES.get(layer, layer.replace("dense_", "pts_linears."))
    return f"{layer}.{'weight' if kind == 'kernel' else 'bias'}"


def input_order(net: dict, layer: str) -> Optional[List[int]]:
    """For a layer reading encoded inputs, the program's input column of
    each of its source input columns; None for the others."""
    W, P = net["width"], point_width(net)
    pc, vc = point_columns(net), view_columns(net)
    if layer == "dense_0":
        return pc
    if layer == f"dense_{SKIP + 1}":
        return [P + j for j in range(W)] + pc
    if layer == "condition_0":
        return list(range(W)) + [W + c for c in vc]
    return None


def to_program(params: Dict[str, torch.Tensor], net: dict) -> Dict[str, torch.Tensor]:
    """The program's state dict (weights [out, in]) of this file's leaves."""
    out = {}
    for name, t in params.items():
        layer, kind = name.split(".")
        if kind == "bias":
            out[program_name(name)] = t.clone()
            continue
        order = input_order(net, layer)
        w = t.t().contiguous()
        if order is not None:
            w = torch.empty_like(w)
            w[:, order] = t.t()
        out[program_name(name)] = w
    return out


def from_program(state: Dict[str, torch.Tensor], net: dict) -> Dict[str, torch.Tensor]:
    """This file's leaves from the program's state dict (``to_program``'s
    inverse)."""
    out = {}
    for name in param_shapes(net):
        layer, kind = name.split(".")
        t = state[program_name(name)]
        if kind == "bias":
            out[name] = t.clone()
            continue
        order = input_order(net, layer)
        out[name] = (t[:, order] if order is not None else t).t().contiguous()
    return out


# -------------------------------------------------------------- cone rays

def camera_dirs(x: torch.Tensor, y: torch.Tensor, K) -> torch.Tensor:
    """Camera-frame directions of pixel coordinates (x right, y down; the
    camera looks down -z)."""
    fx, fy, cx, cy = K[0][0], K[1][1], K[0][2], K[1][2]
    return torch.stack([(x - cx) / fx, -(y - cy) / fy, -torch.ones_like(x)], dim=-1)


def conical_frustum_to_gaussian(d, t0, t1, base_radius):
    """The stable forms: (mean offset, covariance diagonal) [N, S, 3]."""
    mu = (t0 + t1) / 2
    hw = (t1 - t0) / 2
    t_mean = mu + (2 * mu * hw ** 2) / (3 * mu ** 2 + hw ** 2)
    t_var = (hw ** 2) / 3 - (4 / 15) * ((hw ** 4 * (12 * mu ** 2 - hw ** 2))
                                        / (3 * mu ** 2 + hw ** 2) ** 2)
    r_var = base_radius ** 2 * ((mu ** 2) / 4 + (5 / 12) * hw ** 2
                                - 4 / 15 * (hw ** 4) / (3 * mu ** 2 + hw ** 2))
    mean = d[..., None, :] * t_mean[..., None]
    d_mag_sq = torch.clamp(torch.sum(d ** 2, dim=-1, keepdim=True), min=1e-10)
    d_outer = d ** 2
    null_outer = 1 - d_outer / d_mag_sq
    cov = t_var[..., None] * d_outer[..., None, :] + r_var[..., None] * null_outer[..., None, :]
    return mean, cov


def cast_rays(t_vals, origins, directions, radii):
    """(means, covariance diagonals) [N, S, 3] of the intervals of t_vals."""
    mean, cov = conical_frustum_to_gaussian(directions, t_vals[..., :-1], t_vals[..., 1:],
                                            radii)
    return mean + origins[..., None, :], cov


def stratified_edges(n_rays: int, near: float, far: float, n: int, randomized: bool,
                     gen: Optional[torch.Generator], device) -> torch.Tensor:
    """n + 1 edges a ray on [near, far], jittered within their strata."""
    t = torch.linspace(0.0, 1.0, n + 1, device=device)
    t = (near * (1.0 - t) + far * t).expand(n_rays, n + 1)
    if randomized:
        mids = 0.5 * (t[:, 1:] + t[:, :-1])
        upper = torch.cat([mids, t[:, -1:]], dim=-1)
        lower = torch.cat([t[:, :1], mids], dim=-1)
        t = lower + (upper - lower) * torch.rand(t.shape, generator=gen, device=device)
    return t


def sorted_piecewise_constant_pdf(bins, weights, n: int, randomized: bool,
                                  gen: Optional[torch.Generator]):
    """The source's sampler: weights padded to sum at least 1e-5, the CDF
    from 0 to exactly 1, stratified u, each u's interval where the mask
    u >= cdf switches."""
    eps = 1e-5
    weight_sum = torch.sum(weights, dim=-1, keepdim=True)
    padding = torch.clamp(eps - weight_sum, min=0.0)
    weights = weights + padding / weights.shape[-1]
    weight_sum = weight_sum + padding
    pdf = weights / weight_sum
    cdf = torch.clamp(torch.cumsum(pdf[..., :-1], dim=-1), max=1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf, torch.ones_like(cdf[..., :1])], -1)
    shape = (*cdf.shape[:-1], n)
    if randomized:
        s = 1.0 / n
        u = torch.arange(n, device=cdf.device) * s
        u = u + torch.rand(shape, generator=gen, device=cdf.device) * (s - EPS32)
        u = torch.clamp(u, max=1.0 - EPS32)
    else:
        u = torch.linspace(0.0, 1.0 - EPS32, n, device=cdf.device).expand(shape)
    mask = u[..., None, :] >= cdf[..., :, None]

    def find_interval(x):
        x0 = torch.max(torch.where(mask, x[..., None], x[..., :1, None]), dim=-2).values
        x1 = torch.min(torch.where(~mask, x[..., None], x[..., -1:, None]), dim=-2).values
        return x0, x1

    bins_g0, bins_g1 = find_interval(bins)
    cdf_g0, cdf_g1 = find_interval(cdf)
    t = torch.clamp(torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0), 0.0), 0.0, 1.0)
    return bins_g0 + t * (bins_g1 - bins_g0)


def resample_edges(t_vals, weights, padding: float, randomized: bool,
                   gen: Optional[torch.Generator]):
    """The fine edges: blurred, padded coarse weights, as many edges."""
    w = torch.cat([weights[..., :1], weights, weights[..., -1:]], dim=-1)
    w_max = torch.maximum(w[..., :-1], w[..., 1:])
    w_blur = 0.5 * (w_max[..., :-1] + w_max[..., 1:])
    return sorted_piecewise_constant_pdf(t_vals, w_blur + padding, t_vals.shape[-1],
                                         randomized, gen)


def volumetric_rendering(rgb, density, t_vals, dirs, white_bkgd: bool):
    """(composited rgb [N, 3], weights [N, S]) over the intervals."""
    t_dists = t_vals[..., 1:] - t_vals[..., :-1]
    delta = t_dists * torch.linalg.norm(dirs[..., None, :], dim=-1)
    density_delta = density[..., 0] * delta
    alpha = 1 - torch.exp(-density_delta)
    trans = torch.exp(-torch.cat([torch.zeros_like(density_delta[..., :1]),
                                  torch.cumsum(density_delta[..., :-1], dim=-1)], dim=-1))
    weights = alpha * trans
    comp_rgb = (weights[..., None] * rgb).sum(dim=-2)
    if white_bkgd:
        comp_rgb = comp_rgb + (1.0 - weights.sum(dim=-1)[..., None])
    return comp_rgb, weights


def render(params, net: dict, scene: dict, origins, directions, radii, viewdirs,
           randomized: bool, gen: Optional[torch.Generator],
           disable_integration: bool = False) -> List[torch.Tensor]:
    """The composited rgb of each level, coarse first. ``disable_integration``
    zeroes the covariances (the source's flag of the same name)."""
    n, dev = origins.shape[0], origins.device
    views = pos_enc(viewdirs, 0, net["deg_view"], True)
    out = []
    for level in range(2 if scene["N_importance"] > 0 else 1):
        if level == 0:
            t_vals = stratified_edges(n, scene["near"], scene["far"], scene["N_samples"],
                                      randomized, gen, dev)
        else:
            t_vals = resample_edges(t_vals, weights, net["resample_padding"], randomized,
                                    gen).detach()
        mean, cov = cast_rays(t_vals, origins, directions, radii)
        if disable_integration:
            cov = torch.zeros_like(cov)
        enc = integrated_pos_enc(mean, cov, net["min_deg_point"], net["max_deg_point"])
        cond = views[:, None, :].expand(*enc.shape[:-1], views.shape[-1])
        raw_rgb, raw_density = mlp(params, net, enc, cond)
        rgb = torch.sigmoid(raw_rgb) * (1 + 2 * net["rgb_padding"]) - net["rgb_padding"]
        density = F.softplus(raw_density + net["density_bias"])
        comp, weights = volumetric_rendering(rgb, density, t_vals, directions,
                                             scene["white_bkgd"])
        out.append(comp)
    return out


# ------------------------------------------------------------ pixel draws

def _mul32(v, c: int):
    return (v * (c & 0xFFFF) + (((v * (c >> 16)) & 0xFFFF) << 16)) & M32


def _mix(v, k):
    v = _mul32(v ^ k, 0x85EBCA6B)
    v = _mul32(v ^ (v >> 13), 0xC2B2AE35)
    return v ^ (v >> 16)


def _round_keys(key: torch.Tensor, rounds: int) -> torch.Tensor:
    flat = key.reshape(-1).long() & M32
    base = flat[0]
    for w in range(1, flat.shape[0]):
        base = _mix(base, flat[w])
    idx = torch.arange(rounds, dtype=torch.int64)
    return ((base + (idx + 1) * 0x9E3779B9) & M32) | 1


def _feistel(x, lo_bits: int, hi_bits: int, keys):
    lo_mask, hi_mask = (1 << lo_bits) - 1, (1 << hi_bits) - 1
    hi, lo = (x >> lo_bits) & hi_mask, x & lo_mask
    for r in range(0, keys.shape[0], 2):
        hi = (hi ^ _mix(lo, keys[r])) & hi_mask
        lo = (lo ^ _mix(hi, keys[r + 1])) & lo_mask
    return ((hi << lo_bits) | lo) & ((1 << (lo_bits + hi_bits)) - 1)


def feistel_index(key: torch.Tensor, i: torch.Tensor, n: int, rounds: int = 4):
    """The keyed 4-round Feistel permutation of [0, n) with cycle-walking,
    at indices ``i`` (a frozen copy of the program's pixel permutation)."""
    if n == 1:
        return torch.zeros_like(i, dtype=torch.int64)
    bits = (n - 1).bit_length()
    lo_bits = bits // 2
    keys = _round_keys(key, rounds)
    x = _feistel(i.long() & M32, lo_bits, bits - lo_bits, keys)
    while True:
        out = x >= n
        if not bool(out.any()):
            return x
        x = torch.where(out, _feistel(x, lo_bits, bits - lo_bits, keys), x)


def draw_pixels(gen: torch.Generator, n_train: int, scene: dict):
    """(img, y, x) of one step, CPU int64: one image and the first N_rand
    entries of a fresh permutation of its pixels (the program draws a
    second key for its centre crop, unused without one)."""
    N, H, W = scene["N_rand"], scene["H"], scene["W"]
    img = torch.randint(0, n_train, (), generator=gen)
    key_y = torch.randint(0, 1 << 32, (2,), generator=gen, dtype=torch.int64)
    torch.randint(0, 1 << 32, (2,), generator=gen, dtype=torch.int64)
    i = torch.arange(N, dtype=torch.int64)
    flat = feistel_index(key_y, i if N <= H * W else i % (H * W), H * W)
    return img, flat // W, flat % W


def step_rays(images, poses, scene: dict, img, y, x):
    """(origins, directions, radii [N, 1], viewdirs, target) of the drawn
    pixels of image ``img``, on the images' device."""
    dev = images.device
    y, x = y.to(dev), x.to(dev)
    rot = poses[int(img)][:3, :3]
    d = camera_dirs(x.float(), y.float(), scene["K"]) @ rot.t()
    below = camera_dirs(x.float(), (y + 1).float(), scene["K"]) @ rot.t()
    radii = torch.linalg.norm(below - d, dim=-1, keepdim=True) * (2.0 / math.sqrt(12.0))
    origins = poses[int(img)][:3, 3].expand(d.shape)
    viewdirs = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return origins, d, radii, viewdirs, images[int(img)][y, x]


# -------------------------------------------------------------------- Adam

def learning_rate(step: int, net: dict) -> float:
    """The source's ``learning_rate_decay`` at ``step``."""
    delay_steps, delay_mult = net["lr_delay_steps"], net["lr_delay_mult"]
    if delay_steps > 0:
        delay = delay_mult + (1 - delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / delay_steps, 0.0), 1.0))
    else:
        delay = 1.0
    t = min(max(step / net["max_steps"], 0.0), 1.0)
    return delay * math.exp(math.log(net["lr_init"]) * (1 - t) + math.log(net["lr_final"]) * t)


class Adam:
    """Adam (beta 0.9, 0.999, eps 1e-8) at ``learning_rate`` of step k + 1,
    k the number of updates made before this one."""

    def __init__(self, params: Dict[str, torch.Tensor], net: dict):
        self.net, self.k = net, 0
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        lr = learning_rate(self.k + 1, self.net)
        self.k += 1
        c1, c2 = 1.0 - 0.9 ** self.k, 1.0 - 0.999 ** self.k
        for n, p in params.items():
            g = grads[n]
            self.m[n].mul_(0.9).add_(g, alpha=0.1)
            self.v[n].mul_(0.999).addcmul_(g, g, value=0.001)
            denom = self.v[n].sqrt() / math.sqrt(c2) + 1e-8
            p.addcdiv_(self.m[n], denom, value=-lr / c1)


def train_steps(params: Dict[str, torch.Tensor], net: dict, scene: dict, images, poses,
                step_gens: List[torch.Generator], disable_integration: bool = False) -> dict:
    """Train ``len(step_gens)`` steps from ``params`` (this file's layout,
    updated in place). Returns {"loss": [per step], "grad": {name: first
    step's gradient}}."""
    for p in params.values():
        p.requires_grad_(True)
    opt = Adam(params, net)
    losses, first = [], None
    for gen in step_gens:
        img, y, x = draw_pixels(gen, images.shape[0], scene)
        dev_gen = torch.Generator(device=images.device)
        dev_gen.manual_seed(int(torch.randint(0, 1 << 62, (), generator=gen)))
        o, d, radii, vd, target = step_rays(images, poses, scene, img, y, x)
        levels = render(params, net, scene, o, d, radii, vd, True, dev_gen,
                        disable_integration)
        mse = [torch.mean((rgb - target) ** 2) for rgb in levels]
        loss = net["coarse_loss_mult"] * sum(mse[:-1]) + mse[-1]
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        opt.update(params, grads)
        losses.append(float(loss.detach()))
    for p in params.values():
        p.requires_grad_(False)
    return {"loss": losses, "grad": first}
