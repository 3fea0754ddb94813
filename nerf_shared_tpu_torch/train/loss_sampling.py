"""Loss-guided pixel sampling (--loss_sampling).

Counterpart of ``nerf_shared_tpu/train/loss_sampling.py``. A per-(train
image, tile) EMA of the photometric error, ``[n_images, ceil(H/t),
ceil(W/t)]`` fp32 on the device, and a fraction ``frac`` of each step's
N_rand pixels drawn in proportion to it, so rays gather on edges, thin
structures and regions not yet converged.

- The head of the batch, ``N_rand - round(frac * N_rand)`` rays, keeps the
  single-image sampler's uniform draw (train/pipeline.py, resolved on the
  host).
- The tail is drawn on the device from the drawn image's row of the map:
  the tile by inverse CDF (``searchsorted(..., right=True)`` over the
  cumsum of the weights plus ``floor``), then a uniform pixel inside the
  tile, clamped to the image. The draws come from a device generator, so
  the step never reads the map back to the host. ``draws`` pins them
  (``tile_u`` in [0, 1), ``jitter_y`` / ``jitter_x`` in [0, tile), [N_rand]
  each, the tail taken from their last entries, as the JAX sampler draws
  N_rand and keeps the tail).
- While the precrop window is open every ray keeps the uniform (precrop)
  draw.
- The update is a segment sum (``index_add_``) of the step's per-ray
  squared errors into their tiles, blended into the observed tiles only
  (``decay * old + (1 - decay) * mean``); tiles no ray hit keep their value.

The map is not checkpointed: a resume starts it uniform (as in the JAX
package).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from nerf_shared_tpu_torch.train.pipeline import PixelSamplerSpec, pixel_rays, sample_pixels


@dataclasses.dataclass(frozen=True)
class LossSamplingSpec:
    tile: int = 8           # tile edge in pixels
    frac: float = 0.5       # fraction of N_rand drawn from the loss map
    decay: float = 0.9      # EMA decay of observed tiles
    floor: float = 1e-3     # weight floor: no tile starves completely

    def n_weighted(self, n_rand: int) -> int:
        return int(round(self.frac * n_rand))


def grid_shape(H: int, W: int, tile: int) -> Tuple[int, int]:
    return -(-H // tile), -(-W // tile)


def init_loss_map(n_images: int, H: int, W: int, tile: int, device=None) -> torch.Tensor:
    """A uniform map: the first weighted draws are uniform over tiles."""
    return torch.ones((n_images,) + grid_shape(H, W, tile), dtype=torch.float32,
                      device=device)


def draw_weighted_pixels(row: torch.Tensor, n: int, H: int, W: int, tile: int,
                         floor: float, generator: Optional[torch.Generator] = None,
                         draws: Optional[Dict] = None):
    """n (y, x) pixel draws (int64, on ``row``'s device) from the tile
    weights ``row`` [Ht, Wt] + ``floor`` by inverse CDF, each jittered
    uniformly inside its tile and clamped to the image. ``draws`` pins
    ``tile_u`` / ``jitter_y`` / ``jitter_x`` ([n] each)."""
    dev = row.device

    def pinned(name, make):
        if draws is not None and name in draws:
            return torch.as_tensor(draws[name], device=dev)
        return make()

    w = row.reshape(-1) + floor
    cdf = torch.cumsum(w, dim=0)
    u = pinned("tile_u", lambda: torch.rand(n, generator=generator, device=dev))
    t = torch.searchsorted(cdf, u.to(cdf.dtype) * cdf[-1], right=True)
    t = torch.clamp(t, 0, w.shape[0] - 1)
    Wt = row.shape[1]
    jy = pinned("jitter_y", lambda: torch.randint(0, tile, (n,), generator=generator,
                                                  device=dev))
    jx = pinned("jitter_x", lambda: torch.randint(0, tile, (n,), generator=generator,
                                                  device=dev))
    y = torch.clamp(torch.div(t, Wt, rounding_mode="floor") * tile + jy.long(), 0, H - 1)
    x = torch.clamp(t % Wt * tile + jx.long(), 0, W - 1)
    return y, x


@torch.no_grad()
def update_loss_map(lmap: torch.Tensor, img_idx: int, y: torch.Tensor, x: torch.Tensor,
                    err: torch.Tensor, tile: int, decay: float) -> torch.Tensor:
    """Blend the step's mean per-tile error (``err`` [N], the rays' squared
    errors at pixels (y, x) of image ``img_idx``) into the observed tiles
    of that image's row, in place; returns ``lmap``."""
    Ht, Wt = lmap.shape[1], lmap.shape[2]
    t = torch.div(y, tile, rounding_mode="floor") * Wt + torch.div(x, tile,
                                                                   rounding_mode="floor")
    s = torch.zeros(Ht * Wt, dtype=err.dtype, device=err.device).index_add_(0, t, err)
    c = torch.zeros_like(s).index_add_(0, t, torch.ones_like(err))
    mean = s / torch.clamp(c, min=1.0)
    row = lmap[img_idx].reshape(-1)
    lmap[img_idx] = torch.where(c > 0, decay * row + (1.0 - decay) * mean,
                                row).reshape(Ht, Wt)
    return lmap


def weighted_tail(img_idx, y: torch.Tensor, x: torch.Tensor, step: int,
                  spec: PixelSamplerSpec, lmap: torch.Tensor, ls: LossSamplingSpec,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[Dict] = None):
    """(y, x) [N_rand] on the map's device: the uniform draw (y, x) of image
    ``img_idx`` with its last round(frac * N_rand) pixels replaced by
    ``draw_weighted_pixels`` on ``generator`` (a generator on the map's
    device), unless the precrop window is open."""
    dev = lmap.device
    y, x = y.to(dev, non_blocking=True), x.to(dev, non_blocking=True)
    N, n_w = spec.N_rand, ls.n_weighted(spec.N_rand)
    dH = int(spec.H // 2 * spec.precrop_frac)
    dW = int(spec.W // 2 * spec.precrop_frac)
    if n_w <= 0 or (step < spec.precrop_iters and dH > 0 and dW > 0):
        return y, x
    tail = None
    if draws is not None:
        tail = {k: torch.as_tensor(draws[k])[N - n_w:]
                for k in ("tile_u", "jitter_y", "jitter_x") if k in draws}
    y_w, x_w = draw_weighted_pixels(lmap[int(img_idx)], n_w, spec.H, spec.W, ls.tile,
                                    ls.floor, generator=generator, draws=tail)
    return torch.cat([y[:N - n_w], y_w]), torch.cat([x[:N - n_w], x_w])


def sample_ray_batch_weighted(generator: Optional[torch.Generator],
                              device_generator: Optional[torch.Generator],
                              images: torch.Tensor, poses: torch.Tensor, step: int,
                              spec: PixelSamplerSpec, lmap: torch.Tensor,
                              ls: LossSamplingSpec, draws: Optional[Dict] = None):
    """(rays_o, rays_d, target, img_idx [N], y [N], x [N]) of a
    single-image draw with the loss-weighted tail, as the JAX function
    returns them: ``sample_pixels`` on the host ``generator``, then
    ``weighted_tail`` on ``device_generator``."""
    if not spec.single_image:
        raise ValueError(
            "--loss_sampling targets single-image sampling (no_batching); "
            "the batching pipeline draws across all images per step and "
            "would need a per-ray CDF per image")
    img_idx, y, x = sample_pixels(generator, images.shape[0], step, spec, draws)
    y, x = weighted_tail(img_idx, y, x, step, spec, lmap, ls, device_generator, draws)
    rays_o, rays_d, target = pixel_rays(images, poses, spec, img_idx, y, x)
    return rays_o, rays_d, target, torch.full_like(y, int(img_idx)), y, x
