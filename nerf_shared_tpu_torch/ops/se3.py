"""SE(3) pose parameterizations for gradient-based camera optimization.

Counterpart of ``nerf_shared_tpu/ops/se3.py`` (reference
examples/relative_pose_estimation_demo/demo_est_rel_pose.py:190-218):

- ``screw_transform(w, v, theta)``: the reference's (w, v, theta) screw
  form, R = Rodrigues(w, theta), t = V(w, theta) v;
- ``exp_se3(twist)``: the se(3) exponential of [v(3), w(3)], the
  lietorch-style retraction (demo_with_lietorch.py:56-60).

Both are plain torch ops, so autograd carries the photometric gradient from
the pixels through ray generation into the pose parameters. ``exp_se3``
takes any leading batch shape ([..., 6] -> [..., 4, 4]); ``skew`` and
``screw_transform`` take single vectors, as the JAX functions do.
"""

from __future__ import annotations

import torch


def skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    zero = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zero, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], zero, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], zero], -1),
    ], -2)


def _homogeneous(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation and [..., 3] translation -> [..., 4, 4]."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2)


def screw_transform(w: torch.Tensor, v: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Exponential of a screw axis: [4, 4] rigid transform.

    R = I + sin(θ)[w]× + (1-cos(θ))[w]×²
    t = (Iθ + (1-cos(θ))[w]× + (θ-sin(θ))[w]×²) v
    """
    W = skew(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    R = eye + torch.sin(theta) * W + (1.0 - torch.cos(theta)) * W2
    V = eye * theta + (1.0 - torch.cos(theta)) * W + (theta - torch.sin(theta)) * W2
    return _homogeneous(R, V @ v)


def exp_se3(twist: torch.Tensor) -> torch.Tensor:
    """se(3) exponential of [..., 6] twists [v, w] -> [..., 4, 4].

    Taylor-guarded at |w| < 1e-4 with the double ``where``: ``torch.where``
    evaluates both branches and its backward multiplies the untaken one by
    zero, so the untaken branch must stay finite (``safe_theta``) or the
    gradient at identity, where every twist starts, is NaN."""
    v, w = twist[..., :3], twist[..., 3:]
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + 1e-24)
    W = skew(w)
    W2 = W @ W
    use_taylor = theta < 1e-4
    safe_theta = torch.where(use_taylor, torch.ones_like(theta), theta)
    safe_theta2 = safe_theta * safe_theta
    sin_t, cos_t = torch.sin(safe_theta), torch.cos(safe_theta)
    a = torch.where(use_taylor, 1.0 - theta2 / 6.0, sin_t / safe_theta)
    b = torch.where(use_taylor, 0.5 - theta2 / 24.0, (1.0 - cos_t) / safe_theta2)
    c = torch.where(use_taylor, 1.0 / 6.0 - theta2 / 120.0,
                    (safe_theta - sin_t) / (safe_theta2 * safe_theta))
    a, b, c = (s[..., None, None] for s in (a, b, c))
    eye = torch.eye(3, dtype=twist.dtype, device=twist.device)
    R = eye + a * W + b * W2
    V = eye + b * W + c * W2
    return _homogeneous(R, (V @ v[..., :, None])[..., 0])
