"""Per-step ray sampling from device-resident training images.

Counterpart of ``nerf_shared_tpu/train/pipeline.py``: only the training
images [N, H, W, 3] and poses [N, 3, 4] live on the device; each step draws
N_rand pixels and builds exactly their rays there from the intrinsics.

- ``single_image=True`` (the reference's no_batching): one random train
  image per step, N_rand pixels of it drawn without replacement (the first
  N_rand entries of a keyed Feistel permutation, ops/permute.py), inside
  the centre crop while ``step < precrop_iters``.
- ``single_image=False`` (use_batching): N_rand (image, pixel) pairs across
  all images, i.i.d., or with ``exact_epochs`` a without-replacement walk of
  one permutation per epoch. Data-parallel, rank r of n draws its N_rand
  (the local batch) at ``step * n * N_rand + r * N_rand`` of the walk, so
  the ranks' draws of a step are the global batch cut into parts (the JAX
  sharded step offsets by the rank but advances by the local batch, so a
  pixel comes back on the next rank one step later: ROADMAP C).

The draws that decide which pixels are taken (image index, permutation key
words, i.i.d. coordinates) come from a CPU ``torch.Generator`` and are
resolved on the host, where the permutation's cycle-walk can test its end
without waiting for the device; only the N_rand pixel coordinates are
copied to the device (asynchronously). ``draws`` pins them for tests:
``img_idx`` (an int, or [N] in batching mode), ``key_y`` / ``key_x``
(uint32 key words of the full-image and precrop permutations), ``y`` /
``x`` ([N], batching).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nerf_shared_tpu_torch.ops.permute import permute_index

# seed of the exact-epoch permutations: epoch e walks the permutation keyed
# by fold_in(PRNGKey(EPOCH_SEED), e), as the JAX package keys it
EPOCH_SEED = 0x5EED
_M32 = 0xFFFFFFFF


def _threefry2x32(key, count):
    """Threefry-2x32 (20 rounds) of one counter pair under one key pair,
    as jax.random's default generator computes it, on Python ints."""
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    x0, x1 = (count[0] + ks[0]) & _M32, (count[1] + ks[1]) & _M32
    for i in range(5):
        for r in rot[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def epoch_key(e: int) -> torch.Tensor:
    """Key words of epoch e: jax.random.fold_in(PRNGKey(EPOCH_SEED), e)."""
    return torch.tensor(_threefry2x32((0, EPOCH_SEED), (0, e & _M32)),
                        dtype=torch.int64)


@dataclasses.dataclass(frozen=True)
class PixelSamplerSpec:
    """Static description of the sampling problem."""

    H: int
    W: int
    fx: float
    fy: float
    cx: float
    cy: float
    N_rand: int
    single_image: bool = True
    precrop_iters: int = 0
    precrop_frac: float = 0.5
    exact_epochs: bool = False

    @classmethod
    def from_K(cls, H, W, K, N_rand, **kw):
        K = np.asarray(K)
        return cls(H=int(H), W=int(W), fx=float(K[0, 0]), fy=float(K[1, 1]),
                   cx=float(K[0, 2]), cy=float(K[1, 2]), N_rand=int(N_rand), **kw)


def _pixel_dirs(x, y, spec: PixelSamplerSpec):
    """Camera-frame ray directions for float pixel coordinates."""
    return torch.stack([(x - spec.cx) / spec.fx, -(y - spec.cy) / spec.fy,
                        -torch.ones_like(x)], dim=-1)


def _key_words(generator: torch.Generator) -> torch.Tensor:
    return torch.randint(0, 1 << 32, (2,), generator=generator, dtype=torch.int64)


def _first_n(key, N: int, total: int) -> torch.Tensor:
    """The first N entries of the keyed permutation of [0, total)
    (wrapping when N > total, as the JAX sampler does)."""
    i = torch.arange(N, dtype=torch.int64)
    return permute_index(key, i if N <= total else i % total, total)


def sample_pixels(generator: Optional[torch.Generator], n_train: int, step: int,
                  spec: PixelSamplerSpec, draws: Optional[Dict] = None,
                  rank: int = 0, n_ranks: int = 1) -> Tuple[torch.Tensor, ...]:
    """Host side of a step's draw: (img_idx, y, x) as CPU int64 tensors
    ([N] each; img_idx [] in single-image mode). ``rank`` of ``n_ranks``
    places the exact-epoch walk's batch (``spec.N_rand`` the rank's own)."""
    draws = draws or {}
    N, H, W = spec.N_rand, spec.H, spec.W

    def pinned(name, make):
        return torch.as_tensor(np.asarray(draws[name]), dtype=torch.int64) \
            if name in draws else make()

    if spec.single_image:
        img_idx = pinned("img_idx", lambda: torch.randint(
            0, n_train, (), generator=generator))
        key_y = pinned("key_y", lambda: _key_words(generator))
        key_x = pinned("key_x", lambda: _key_words(generator))
        dH, dW = int(H // 2 * spec.precrop_frac), int(W // 2 * spec.precrop_frac)
        if step < spec.precrop_iters and dH > 0 and dW > 0:
            flat = _first_n(key_x, N, 4 * dH * dW)
            y, x = H // 2 - dH + flat // (2 * dW), W // 2 - dW + flat % (2 * dW)
        else:
            flat = _first_n(key_y, N, H * W)
            y, x = flat // W, flat % W
        return img_idx, y, x
    if spec.exact_epochs:
        total = n_train * H * W
        g = (step * n_ranks + rank) * N + torch.arange(N, dtype=torch.int64)
        epoch, pos = g // total, g % total
        flat = torch.empty_like(pos)
        for e in torch.unique(epoch).tolist():
            sel = epoch == e
            flat[sel] = permute_index(epoch_key(e), pos[sel], total)
        rest = flat % (H * W)
        return flat // (H * W), rest // W, rest % W
    img_idx = pinned("img_idx", lambda: torch.randint(0, n_train, (N,), generator=generator))
    y = pinned("y", lambda: torch.randint(0, H, (N,), generator=generator))
    x = pinned("x", lambda: torch.randint(0, W, (N,), generator=generator))
    return img_idx, y, x


def sample_ray_batch(generator: Optional[torch.Generator], images: torch.Tensor,
                     poses: torch.Tensor, step: int, spec: PixelSamplerSpec,
                     draws: Optional[Dict] = None):
    """Draw N_rand rays and their target pixels: (rays_o [N, 3], rays_d
    [N, 3], target [N, 3]) on the images' device."""
    pixels = sample_pixels(generator, images.shape[0], step, spec, draws)
    return pixel_rays(images, poses, spec, *pixels)


def pixel_rays(images: torch.Tensor, poses: torch.Tensor, spec: PixelSamplerSpec,
               img_idx: torch.Tensor, y: torch.Tensor, x: torch.Tensor):
    """The rays and target pixels of drawn pixels (sample_pixels' host
    tensors): (rays_o, rays_d, target) on the images' device. ``poses`` may
    carry a gradient (the pose-refined poses of train/step.py): the rays
    are differentiable in them."""
    dev = images.device
    y, x = y.to(dev, non_blocking=True), x.to(dev, non_blocking=True)
    rays_d = pixel_dirs(poses, spec, img_idx, y, x)
    if img_idx.dim() == 0:
        rays_o = poses[int(img_idx)][:3, 3].expand(rays_d.shape)
        target = images[int(img_idx)][y, x]
    else:
        img_idx = img_idx.to(dev, non_blocking=True)
        rays_o = poses[img_idx][:, :3, 3]
        target = images[img_idx, y, x]
    return rays_o.contiguous(), rays_d.contiguous(), target


def pixel_dirs(poses: torch.Tensor, spec: PixelSamplerSpec, img_idx: torch.Tensor,
               y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The unnormalised world directions [N, 3] of pixels (y, x) of the
    drawn images (any y, the row below the image's last included: mip-NeRF's
    cone radii read it), on the poses' device."""
    dev = poses.device
    y, x = y.to(dev, non_blocking=True), x.to(dev, non_blocking=True)
    dirs = _pixel_dirs(x.to(poses.dtype), y.to(poses.dtype), spec)
    if img_idx.dim() == 0:
        return dirs @ poses[int(img_idx)][:3, :3].t()
    pose = poses[img_idx.to(dev, non_blocking=True)]
    return torch.einsum("nc,nrc->nr", dirs, pose[:, :3, :3])
