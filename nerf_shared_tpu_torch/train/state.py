"""Training state: coarse + fine networks, one Adam, the step counters.

Counterpart of ``nerf_shared_tpu/train/state.py`` (reference
utils.py:163-172, main.py:107-112): one Adam(betas=(0.9, 0.999), eps=1e-8)
over the coarse then the fine parameters, in ``torch_param_order`` (the
order of the reference module's parameters, which the ``.tar`` optimizer
state indexes). Before each update the learning rate is set to

    lr(k) = lrate * 0.1 ** (k / (lrate_decay * 1000)),

k the number of updates Adam has made (its count, which resumes from a
checkpoint): the optax schedule of the JAX package evaluated at the same
count. optax's Adam and torch's compute the same update,
m̂ / (sqrt(v̂) + eps), with m̂, v̂ bias-corrected by the updated count.

Only the field's parameter group is ported: the grid-family, pose-twist
and appearance groups raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from nerf_shared_tpu_torch.models.nerf import NeRF, NeRFConfig, torch_param_order


def lr_at(lrate: float, lrate_decay: int, count: int) -> float:
    """Continuous exponential decay at Adam count ``count``."""
    return lrate * 0.1 ** (count / (lrate_decay * 1000))


class TrainState:
    """The trained networks, their Adam, ``step`` (the global step, saved
    as the checkpoint's global_step) and ``count`` (Adam's update count,
    which drives the learning rate)."""

    def __init__(self, coarse: NeRF, fine: Optional[NeRF], lrate: float,
                 lrate_decay: int):
        self.coarse, self.fine = coarse, fine
        self.lrate, self.lrate_decay = float(lrate), lrate_decay
        self.step = 0
        self.count = 0
        self.optimizer = torch.optim.Adam(self.parameters(), lr=self.lrate,
                                          betas=(0.9, 0.999), eps=1e-8)

    def branches(self):
        """(name, module) of the trained networks, coarse first."""
        out = [("coarse", self.coarse)]
        if self.fine is not None:
            out.append(("fine", self.fine))
        return out

    def parameters(self) -> list:
        """Every trained tensor: coarse then fine, each in
        torch_param_order (the Adam state's indices)."""
        out = []
        for _, m in self.branches():
            p = m.params()
            out += [p[k] for k in torch_param_order(m.cfg)]
        return out

    def lr(self) -> float:
        return lr_at(self.lrate, self.lrate_decay, self.count)

    def apply_gradients(self):
        """One Adam update at lr(count) from the parameters' .grad."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr()
        self.optimizer.step()
        self.count += 1
        self.step += 1


def create_train_state(coarse_cfg: NeRFConfig, fine_cfg: Optional[NeRFConfig],
                       device, seed: int = 0, lrate: float = 5e-4,
                       lrate_decay: int = 250, grid_lrate: Optional[float] = None,
                       n_refine_poses: int = 0, n_appearance: int = 0) -> TrainState:
    """Seeded networks (one torch.Generator from ``seed``, coarse then
    fine, as factory.create_nerf_models draws them) and a fresh Adam."""
    if grid_lrate is not None:
        raise NotImplementedError(
            "the grid parameter group (grid model families) is not ported to "
            "nerf_shared_tpu_torch yet: ROADMAP A15")
    if n_refine_poses:
        raise NotImplementedError(
            "the pose-twist parameter group (--refine_poses) is not ported to "
            "nerf_shared_tpu_torch yet: ROADMAP A11")
    if n_appearance:
        raise NotImplementedError(
            "the appearance parameter group (--appearance) is not ported to "
            "nerf_shared_tpu_torch yet: ROADMAP A11")
    g = torch.Generator().manual_seed(int(seed))
    coarse = NeRF(coarse_cfg, device=device, generator=g)
    fine = NeRF(fine_cfg, device=device, generator=g) if fine_cfg is not None else None
    return TrainState(coarse, fine, lrate, lrate_decay)
