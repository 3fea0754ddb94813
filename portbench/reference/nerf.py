"""Plain reference of the NeRF MLP: its training step and its dense frame.

Written from the published description (Mildenhall et al., "NeRF:
Representing Scenes as Neural Radiance Fields for View Synthesis", ECCV
2020) as nerf-pytorch lays it out: the positional encoding
[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(L-1) x), cos(2^(L-1) x)], D layers
of width W with ReLU and the encoded points concatenated back in after each
layer in ``skips``, the alpha head, the feature layer, one view layer of
width W/2 on [feature, encoded direction] and the rgb head; pinhole rays,
the NDC warp of forward-facing scenes, stratified samples, inverse-CDF
resampling on the coarse weights, alpha compositing with the 1e10 final
interval, the MSE of both passes and Adam with the exponential rate decay.

Plain PyTorch in float32 with TF32 off (``no_tf32``), no kernels, no
batching beyond blocks of rays. It imports nothing of the measured program.
The random draws follow the program's protocol so that both sides see the
same ones: a CPU ``torch.Generator`` per step draws the pixels (one image
and the first N entries of a keyed Feistel permutation, or i.i.d. image and
pixel indices) and the seed of a device generator, which draws the
stratified jitter, the sigma noise and the inverse-CDF positions in that
order. ``feistel_index`` is a frozen copy of that permutation.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

M32 = 0xFFFFFFFF


def no_tf32():
    """fp32 products in full fp32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ----------------------------------------------------------------- network

def encoded_width(n_freqs: int, dims: int = 3) -> int:
    return dims + dims * 2 * n_freqs


def param_shapes(depth: int, width: int, skips, multires: int,
                 multires_views: int) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every leaf in nerf-pytorch's order; weights are
    [out, in]."""
    p, v = encoded_width(multires), encoded_width(multires_views)
    out = []
    for i in range(depth):
        fan_in = p if i == 0 else (width + p if (i - 1) in skips else width)
        out += [(f"pts_linears.{i}.weight", (width, fan_in)),
                (f"pts_linears.{i}.bias", (width,))]
    out += [("views_linears.0.weight", (width // 2, width + v)),
            ("views_linears.0.bias", (width // 2,)),
            ("feature_linear.weight", (width, width)), ("feature_linear.bias", (width,)),
            ("alpha_linear.weight", (1, width)), ("alpha_linear.bias", (1,)),
            ("rgb_linear.weight", (3, width // 2)), ("rgb_linear.bias", (3,))]
    return out


def encode(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """[x, sin(f0 x), cos(f0 x), sin(f1 x), ...] with f_k = 2^k."""
    parts = [x]
    for k in range(n_freqs):
        f = float(2 ** k)
        parts += [torch.sin(x * f), torch.cos(x * f)]
    return torch.cat(parts, dim=-1)


def mlp(params: Dict[str, torch.Tensor], net: dict, pts: torch.Tensor,
        viewdirs: torch.Tensor) -> torch.Tensor:
    """raw [..., S, 4] (rgb logits, sigma) of points [..., S, 3] seen along
    view directions [..., 3]."""
    x = encode(pts, net["multires"])
    d = encode(viewdirs, net["multires_views"])[..., None, :].expand(
        *pts.shape[:-1], -1)
    h = x
    for i in range(net["depth"]):
        h = F.relu(F.linear(h, params[f"pts_linears.{i}.weight"],
                            params[f"pts_linears.{i}.bias"]))
        if i in net["skips"]:
            h = torch.cat([x, h], dim=-1)
    alpha = F.linear(h, params["alpha_linear.weight"], params["alpha_linear.bias"])
    feature = F.linear(h, params["feature_linear.weight"], params["feature_linear.bias"])
    hv = F.relu(F.linear(torch.cat([feature, d], dim=-1),
                         params["views_linears.0.weight"], params["views_linears.0.bias"]))
    rgb = F.linear(hv, params["rgb_linear.weight"], params["rgb_linear.bias"])
    return torch.cat([rgb, alpha], dim=-1)


# -------------------------------------------------------------------- rays

def camera_dirs(x: torch.Tensor, y: torch.Tensor, K) -> torch.Tensor:
    """Camera-frame directions of pixel coordinates (x right, y down; the
    camera looks down -z)."""
    fx, fy, cx, cy = K[0][0], K[1][1], K[0][2], K[1][2]
    return torch.stack([(x - cx) / fx, -(y - cy) / fy, -torch.ones_like(x)], dim=-1)


def ndc(H: int, W: int, focal: float, near: float, rays_o, rays_d):
    """Origins moved to the plane z = -near, then the projective warp of
    forward-facing scenes to normalised device coordinates."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    ox, oy, oz = rays_o[..., 0], rays_o[..., 1], rays_o[..., 2]
    dx, dy, dz = rays_d[..., 0], rays_d[..., 1], rays_d[..., 2]
    o = torch.stack([-2.0 * focal / W * ox / oz, -2.0 * focal / H * oy / oz,
                     1.0 + 2.0 * near / oz], dim=-1)
    d = torch.stack([-2.0 * focal / W * (dx / dz - ox / oz),
                     -2.0 * focal / H * (dy / dz - oy / oz), -2.0 * near / oz], dim=-1)
    return o, d


def frame_rays(H: int, W: int, K, c2w: torch.Tensor):
    """(rays_o, rays_d) [H*W, 3] of every pixel of a frame, row-major."""
    dev = c2w.device
    y, x = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    dirs = camera_dirs(x.reshape(-1), y.reshape(-1), K)
    rays_d = dirs @ c2w[:3, :3].t()
    return c2w[:3, 3].expand(rays_d.shape).contiguous(), rays_d


def prepare(rays_o, rays_d, scene: dict):
    """(rays_o, rays_d, viewdirs) as the network sees them: view directions
    from the world rays, then the NDC warp where the scene asks for it."""
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    if scene["ndc"]:
        rays_o, rays_d = ndc(scene["H"], scene["W"], scene["focal"], 1.0, rays_o, rays_d)
    return rays_o, rays_d, viewdirs


# ---------------------------------------------------------------- sampling

def stratified(n_rays: int, near: float, far: float, n: int, perturb: bool,
               gen: Optional[torch.Generator], device) -> torch.Tensor:
    t = torch.linspace(0.0, 1.0, n, device=device)
    z = (near * (1.0 - t) + far * t).expand(n_rays, n)
    if perturb:
        mids = 0.5 * (z[:, 1:] + z[:, :-1])
        upper = torch.cat([mids, z[:, -1:]], dim=-1)
        lower = torch.cat([z[:, :1], mids], dim=-1)
        z = lower + (upper - lower) * torch.rand(z.shape, generator=gen, device=device)
    return z


def inverse_cdf(bins: torch.Tensor, weights: torch.Tensor, n: int, det: bool,
                gen: Optional[torch.Generator]) -> torch.Tensor:
    """n depths per ray drawn from the piecewise-constant pdf of ``weights``
    over ``bins`` (nerf-pytorch's sample_pdf: +1e-5 floor, 1e-5 guard)."""
    w = weights + 1e-5
    cdf = torch.cumsum(w / w.sum(dim=-1, keepdim=True), dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    if det:
        u = torch.linspace(0.0, 1.0, n, device=bins.device).expand(cdf.shape[0], n)
    else:
        u = torch.rand((cdf.shape[0], n), generator=gen, device=bins.device)
    u = u.contiguous()
    idx = torch.searchsorted(cdf.contiguous(), u, right=True)
    lo = torch.clamp(idx - 1, min=0)
    hi = torch.clamp(idx, max=cdf.shape[-1] - 1)
    c0, c1 = torch.gather(cdf, 1, lo), torch.gather(cdf, 1, hi)
    b0, b1 = torch.gather(bins, 1, lo), torch.gather(bins, 1, hi)
    den = c1 - c0
    den = torch.where(den < 1e-5, torch.ones_like(den), den)
    return b0 + (u - c0) / den * (b1 - b0)


def composite(raw, z, rays_d, noise_std: float, white_bkgd: bool,
              gen: Optional[torch.Generator]):
    """(rgb [N, 3], weights [N, S]) of raw [N, S, 4] at depths z."""
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    sigma = raw[..., 3]
    if noise_std > 0.0:
        sigma = sigma + torch.randn(sigma.shape, generator=gen, device=sigma.device) * noise_std
    alpha = 1.0 - torch.exp(-F.relu(sigma) * dists)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    weights = alpha * trans
    rgb = torch.sum(weights[..., None] * torch.sigmoid(raw[..., :3]), dim=-2)
    if white_bkgd:
        rgb = rgb + (1.0 - weights.sum(dim=-1, keepdim=True))
    return rgb, weights


def render(params_c, params_f, net: dict, scene: dict, rays_o, rays_d, viewdirs,
           train: bool, gen: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
    """The hierarchical render of prepared rays: {"rgb0" coarse, "rgb"
    fine, "sigma_last" the fine network's raw sigma at each ray's last
    sample}. ``train``: stratified jitter, sigma noise and random
    inverse-CDF draws from ``gen``; else the deterministic eval render."""
    n, dev = rays_o.shape[0], rays_o.device
    noise = scene["raw_noise_std"] if train else 0.0
    z = stratified(n, scene["near"], scene["far"], scene["N_samples"], train, gen, dev)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    rgb0, w = composite(mlp(params_c, net, pts, viewdirs), z, rays_d, noise,
                        scene["white_bkgd"], gen)
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    zf = inverse_cdf(mids, w[:, 1:-1], scene["N_importance"], not train, gen).detach()
    z = torch.sort(torch.cat([z, zf], dim=-1), dim=-1).values
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    raw = mlp(params_f, net, pts, viewdirs)
    rgb, _ = composite(raw, z, rays_d, noise, scene["white_bkgd"], gen)
    return {"rgb0": rgb0, "rgb": rgb, "sigma_last": raw[:, -1, 3]}


@torch.no_grad()
def render_frame(params_c, params_f, net: dict, scene: dict, c2w: torch.Tensor,
                 block: int = 8192) -> Dict[str, torch.Tensor]:
    """The eval render of one frame [H, W, 3] (and the fine sigma at each
    ray's last sample, [H, W]) in blocks of ``block`` rays."""
    o, d = frame_rays(scene["H"], scene["W"], scene["K"], c2w)
    rgb, sig = [], []
    for i in range(0, o.shape[0], block):
        ro, rd, vd = prepare(o[i:i + block], d[i:i + block], scene)
        out = render(params_c, params_f, net, scene, ro, rd, vd, False, None)
        rgb.append(out["rgb"])
        sig.append(out["sigma_last"])
    H, W = scene["H"], scene["W"]
    return {"rgb": torch.cat(rgb).reshape(H, W, 3), "sigma_last": torch.cat(sig).reshape(H, W)}


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


def draw_pixels(gen: torch.Generator, n_train: int, step: int, scene: dict):
    """(img_idx, y, x) of one step, CPU int64: one image and the first
    N_rand entries of a fresh permutation (inside the centre crop while
    step < precrop_iters), or N_rand i.i.d. (image, y, x) triples."""
    N, H, W = scene["N_rand"], scene["H"], scene["W"]
    if not scene["single_image"]:
        img = torch.randint(0, n_train, (N,), generator=gen)
        y = torch.randint(0, H, (N,), generator=gen)
        x = torch.randint(0, W, (N,), generator=gen)
        return img, y, x
    img = torch.randint(0, n_train, (), generator=gen)
    key_y = torch.randint(0, 1 << 32, (2,), generator=gen, dtype=torch.int64)
    key_x = torch.randint(0, 1 << 32, (2,), generator=gen, dtype=torch.int64)
    dH = int(H // 2 * scene["precrop_frac"])
    dW = int(W // 2 * scene["precrop_frac"])
    i = torch.arange(N, dtype=torch.int64)
    if step < scene["precrop_iters"] and dH > 0 and dW > 0:
        total = 4 * dH * dW
        flat = feistel_index(key_x, i if N <= total else i % total, total)
        return img, H // 2 - dH + flat // (2 * dW), W // 2 - dW + flat % (2 * dW)
    flat = feistel_index(key_y, i if N <= H * W else i % (H * W), H * W)
    return img, flat // W, flat % W


def step_rays(images, poses, scene: dict, img, y, x):
    """(rays_o, rays_d, target) of drawn pixels, on the images' device."""
    dev = images.device
    y, x = y.to(dev), x.to(dev)
    dirs = camera_dirs(x.float(), y.float(), scene["K"])
    if img.dim() == 0:
        pose = poses[int(img)]
        rays_d = dirs @ pose[:3, :3].t()
        return pose[:3, 3].expand(rays_d.shape), rays_d, images[int(img)][y, x]
    img = img.to(dev)
    pose = poses[img]
    rays_d = torch.einsum("nc,nrc->nr", dirs, pose[:, :3, :3])
    return pose[:, :3, 3], rays_d, images[img, y, x]


# -------------------------------------------------------------------- Adam

class Adam:
    """Adam (beta 0.9, 0.999, eps 1e-8) at lr(k) = lrate * 0.1^(k / (decay
    * 1000)), k the number of updates made before this one."""

    def __init__(self, params: Dict[str, torch.Tensor], lrate: float, decay: int):
        self.lrate, self.decay, self.k = lrate, decay, 0
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        lr = self.lrate * 0.1 ** (self.k / (self.decay * 1000))
        self.k += 1
        c1, c2 = 1.0 - 0.9 ** self.k, 1.0 - 0.999 ** self.k
        for n, p in params.items():
            g = grads[n]
            self.m[n].mul_(0.9).add_(g, alpha=0.1)
            self.v[n].mul_(0.999).addcmul_(g, g, value=0.001)
            denom = self.v[n].sqrt() / math.sqrt(c2) + 1e-8
            p.addcdiv_(self.m[n], denom, value=-lr / c1)


def train_steps(params: Dict[str, Dict[str, torch.Tensor]], net: dict, scene: dict,
                images, poses, step_gens: List[torch.Generator], lrate: float,
                decay: int) -> dict:
    """Train ``len(step_gens)`` steps from ``params`` ({"coarse", "fine":
    name -> tensor}, updated in place). Returns {"loss": [per step],
    "grad": {(branch, name): first step's gradient}}."""
    flat = {(b, n): p.requires_grad_(True) for b in ("coarse", "fine")
            for n, p in params[b].items()}
    opt = Adam(flat, lrate, decay)
    losses, first = [], None
    for step, gen in enumerate(step_gens):
        img, y, x = draw_pixels(gen, images.shape[0], step, scene)
        dev_gen = torch.Generator(device=images.device)
        dev_gen.manual_seed(int(torch.randint(0, 1 << 62, (), generator=gen)))
        o, d, target = step_rays(images, poses, scene, img, y, x)
        o, d, vd = prepare(o, d, scene)
        out = render(params["coarse"], params["fine"], net, scene, o, d, vd, True, dev_gen)
        loss = torch.mean((out["rgb"] - target) ** 2) + torch.mean((out["rgb0"] - target) ** 2)
        grads = torch.autograd.grad(loss, list(flat.values()))
        grads = dict(zip(flat, grads))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        opt.update(flat, grads)
        losses.append(float(loss.detach()))
    for p in flat.values():
        p.requires_grad_(False)
    return {"loss": losses, "grad": first}
