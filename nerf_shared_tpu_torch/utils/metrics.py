"""Image metrics (reference utils.py:24-30); counterpart of
``nerf_shared_tpu/utils/metrics.py`` for to8b / img2mse / mse2psnr."""

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
