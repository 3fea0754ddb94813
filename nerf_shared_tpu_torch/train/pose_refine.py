"""Training-time camera-pose refinement (BARF-style, Lin et al. 2021).

Counterpart of ``nerf_shared_tpu/train/pose_refine.py``: each training
image carries a learnable se(3) correction ``twist_i`` (zero-initialized,
the identity) applied to the left of its camera-to-world pose,

    c2w_i' = exp_se3(twist_i) @ [c2w_i; 0 0 0 1],

trained with the field through ray generation: the training step builds
its rays from the corrected poses inside autograd (train/step.py), so the
photometric gradient reaches the twists through rays_o / rays_d.
"""

from __future__ import annotations

import torch

from nerf_shared_tpu_torch.ops.se3 import exp_se3


def init_pose_twists(n_images: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Zero twists: identity corrections, [n_images, 6]."""
    return torch.zeros((n_images, 6), dtype=dtype, device=device)


def apply_pose_twists(twists: torch.Tensor, poses: torch.Tensor) -> torch.Tensor:
    """exp(twist_i) @ pose_i for [N, 6] twists and [N, 3, 4] (or [N, 4, 4])
    poses, returned in the poses' shape."""
    corr = exp_se3(twists)                                        # [N, 4, 4]
    hom = poses
    if poses.shape[-2] == 3:
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=poses.dtype, device=poses.device)
        hom = torch.cat([poses, bottom.expand(poses.shape[0], 1, 4)], dim=-2)
    return torch.einsum("nij,njk->nik", corr, hom)[:, : poses.shape[-2], :]
