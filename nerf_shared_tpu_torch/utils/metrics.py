"""Image metrics (reference utils.py:24-30, plus SSIM); counterpart of
``nerf_shared_tpu/utils/metrics.py``."""

from __future__ import annotations

import math

import numpy as np
import torch


def img2mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean squared error between rendered and target pixels."""
    return torch.mean((x - y) ** 2)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    """MSE -> peak signal-to-noise ratio in dB."""
    return -10.0 * torch.log(mse) / math.log(10.0)


def to8b(x) -> np.ndarray:
    """[0,1] float image -> uint8 (host-side)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return (255 * np.clip(np.asarray(x), 0, 1)).astype(np.uint8)


def ssim(img0, img1, max_val: float = 1.0, filter_size: int = 11,
         filter_sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Structural similarity (Wang et al. 2004) of two [H, W, C] images
    (counterpart of ``nerf_shared_tpu/utils/metrics.py`` ssim): 11x11
    Gaussian window of sigma 1.5, valid padding, population covariance,
    averaged over channels and positions; the window shrinks to fit images
    smaller than it. Separable: two 1-D filters per moment."""
    img0 = torch.as_tensor(img0, dtype=torch.float32)
    img1 = torch.as_tensor(img1, dtype=torch.float32, device=img0.device)
    if img0.dim() == 2:
        img0, img1 = img0[..., None], img1[..., None]
    filter_size = min(filter_size, img0.shape[0], img0.shape[1])
    shift = torch.arange(filter_size, dtype=torch.float32, device=img0.device) \
        - filter_size // 2
    filt = torch.exp(-0.5 * (shift / filter_sigma) ** 2)
    filt = filt / filt.sum()

    def blur(img):  # [H, W, C] -> [H - 2hw, W - 2hw, C]
        return img.unfold(0, filter_size, 1).matmul(filt).unfold(
            1, filter_size, 1).matmul(filt)

    mu0, mu1 = blur(img0), blur(img1)
    sigma00 = torch.clamp(blur(img0 * img0) - mu0 * mu0, min=0.0)
    sigma11 = torch.clamp(blur(img1 * img1) - mu1 * mu1, min=0.0)
    sigma01 = blur(img0 * img1) - mu0 * mu1
    c1, c2 = (k1 * max_val) ** 2, (k2 * max_val) ** 2
    num = (2 * mu0 * mu1 + c1) * (2 * sigma01 + c2)
    den = (mu0 ** 2 + mu1 ** 2 + c1) * (sigma00 + sigma11 + c2)
    return torch.mean(num / den)
