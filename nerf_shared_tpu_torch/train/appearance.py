"""Per-image appearance correction (--appearance): exposure and white
balance learned with the field.

Counterpart of ``nerf_shared_tpu/train/appearance.py``: a per-image
diagonal affine map of the composited colour of every pass (coarse and
fine) before the photometric loss,

    rgb'_r = rgb_r * exp(gain[img_r]) + offset[img_r]        (3 + 3 per image),

zero-initialized (the identity). Image 0's correction is pinned to the
identity by default (the exposure gauge, like the pose-twist anchor). Eval
renders use the uncorrected field. The correction touches no kernel.
"""

from __future__ import annotations

from typing import Dict

import torch


def init_appearance(n_images: int, device=None, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Zero gains and offsets, [n_images, 3] each."""
    return {"gain": torch.zeros((n_images, 3), dtype=dtype, device=device),
            "offset": torch.zeros((n_images, 3), dtype=dtype, device=device)}


def anchor_appearance(app: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Image 0's correction pinned to the identity (zero gradient through
    the mask)."""
    mask = torch.ones((app["gain"].shape[0], 1), dtype=app["gain"].dtype,
                      device=app["gain"].device)
    mask[0, 0] = 0.0
    return {"gain": app["gain"] * mask, "offset": app["offset"] * mask}


def apply_appearance(app: Dict[str, torch.Tensor], img_idx: torch.Tensor,
                     rgb: torch.Tensor) -> torch.Tensor:
    """rgb [R, 3] * exp(gain[img]) + offset[img], ``img_idx`` [R] or one
    index for every ray."""
    idx = img_idx.expand(rgb.shape[:-1])
    return rgb * torch.exp(app["gain"][idx]) + app["offset"][idx]
