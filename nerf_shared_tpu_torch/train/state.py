"""Training state: coarse + fine fields, Adam, the step counters.

Counterpart of ``nerf_shared_tpu/train/state.py`` (reference
utils.py:163-172, main.py:107-112): Adam(betas=(0.9, 0.999), eps=1e-8) over
the coarse then the fine parameters. For the MLP family one group in
``torch_param_order`` (the order of the reference module's parameters,
which the ``.tar`` optimizer state indexes). When a branch is a grid family
(models/hashgrid.py, models/triplane.py) two groups, as the JAX package's
``optax.multi_transform``: "grid" (every parameter under ``tables`` or
``planes``) at ``grid_lrate`` (2e-2 by default) and "net" (the decoders) at
``lrate``. Before each update every group's rate is set to

    lr(k) = group_lrate * 0.1 ** (k / (lrate_decay * 1000)),

k the state's ``count``, the learning-rate schedule's count (the optax
schedule of the JAX package evaluated at the same count). optax's Adam and
torch's compute the same update, m̂ / (sqrt(v̂) + eps), bias-corrected by
Adam's own count, which torch keeps per parameter (``step``).

``fresh_state_at`` restarts Adam over new parameters (a triplane upsample)
while ``count`` continues: the schedule goes on, Adam's own step restarts at
0 with zeroed moments, so bias correction stays on. The pose-twist and
appearance groups raise (ROADMAP A11).
"""

from __future__ import annotations

from typing import Optional

import torch

from nerf_shared_tpu_torch.models.hashgrid import HashGrid, HashGridConfig
from nerf_shared_tpu_torch.models.nerf import NeRF, NeRFConfig, torch_param_order
from nerf_shared_tpu_torch.models.triplane import Triplane, TriplaneConfig

GRID_KEYS = ("tables", "planes")   # parameters of the "grid" Adam group


def lr_at(lrate: float, lrate_decay: int, count: int) -> float:
    """Continuous exponential decay at schedule count ``count``."""
    return lrate * 0.1 ** (count / (lrate_decay * 1000))


def make_model(cfg, device=None, generator: Optional[torch.Generator] = None):
    """The field module of a config: NeRF, HashGrid or Triplane."""
    for cfg_type, module in ((NeRFConfig, NeRF), (HashGridConfig, HashGrid),
                             (TriplaneConfig, Triplane)):
        if isinstance(cfg, cfg_type):
            return module(cfg, device=device, generator=generator)
    raise TypeError(f"unknown model config type {type(cfg).__name__}")


def param_names(model) -> list:
    """A field's parameter names in the order Adam's state indexes them:
    the reference module's order for the MLP, registration order (grid
    tables or planes first, then the decoder) for the grid families."""
    if isinstance(model, NeRF):
        return torch_param_order(model.cfg)
    return list(model.params())


def group_label(name: str) -> str:
    """'grid' for a grid-family feature table or plane, else 'net'."""
    return "grid" if name.split(".")[0] in GRID_KEYS else "net"


class TrainState:
    """The trained fields, their Adam, ``step`` (the global step, saved as
    the checkpoint's global_step) and ``count`` (the learning-rate
    schedule's count). ``grid_lrate`` None: one Adam group; else the
    "net" and "grid" groups."""

    def __init__(self, coarse, fine, lrate: float, lrate_decay: int,
                 grid_lrate: Optional[float] = None):
        self.coarse, self.fine = coarse, fine
        self.lrate, self.lrate_decay = float(lrate), lrate_decay
        self.grid_lrate = None if grid_lrate is None else float(grid_lrate)
        self.step = 0
        self.count = 0
        if self.grid_lrate is None:
            groups = [{"params": self.parameters(), "label": "net",
                       "base_lr": self.lrate}]
        else:
            named = self.named_parameters()
            groups = [{"params": [p for (_, n), p in named.items()
                                  if group_label(n) == label],
                       "label": label, "base_lr": rate}
                      for label, rate in (("net", self.lrate),
                                          ("grid", self.grid_lrate))]
        self.optimizer = torch.optim.Adam(groups, lr=self.lrate,
                                          betas=(0.9, 0.999), eps=1e-8)

    def branches(self):
        """(name, module) of the trained fields, coarse first."""
        out = [("coarse", self.coarse)]
        if self.fine is not None:
            out.append(("fine", self.fine))
        return out

    def named_parameters(self) -> dict:
        """{(branch, name): tensor}, coarse then fine, each in
        ``param_names`` order (the Adam state's indices)."""
        out = {}
        for b, m in self.branches():
            p = m.params()
            for k in param_names(m):
                out[(b, k)] = p[k]
        return out

    def parameters(self) -> list:
        return list(self.named_parameters().values())

    def lr(self) -> float:
        """The net group's rate at the current count."""
        return lr_at(self.lrate, self.lrate_decay, self.count)

    def apply_gradients(self):
        """One Adam update at each group's lr(count) from the parameters'
        .grad."""
        for group in self.optimizer.param_groups:
            group["lr"] = lr_at(group["base_lr"], self.lrate_decay, self.count)
        self.optimizer.step()
        self.count += 1
        self.step += 1


def create_train_state(coarse_cfg, fine_cfg, device, seed: int = 0,
                       lrate: float = 5e-4, lrate_decay: int = 250,
                       grid_lrate: Optional[float] = None,
                       n_refine_poses: int = 0, n_appearance: int = 0) -> TrainState:
    """Seeded fields (one torch.Generator from ``seed``, coarse then fine)
    and a fresh Adam; the grid group's rate defaults to 2e-2 whenever a
    branch is a grid family."""
    if n_refine_poses:
        raise NotImplementedError(
            "the pose-twist parameter group (--refine_poses) is not ported to "
            "nerf_shared_tpu_torch yet: ROADMAP A11")
    if n_appearance:
        raise NotImplementedError(
            "the appearance parameter group (--appearance) is not ported to "
            "nerf_shared_tpu_torch yet: ROADMAP A11")
    g = torch.Generator().manual_seed(int(seed))
    coarse = make_model(coarse_cfg, device, g)
    fine = make_model(fine_cfg, device, g) if fine_cfg is not None else None
    if grid_lrate is None and any(c is not None and not isinstance(c, NeRFConfig)
                                  for c in (coarse_cfg, fine_cfg)):
        grid_lrate = 2e-2
    return TrainState(coarse, fine, lrate, lrate_decay, grid_lrate)


def fresh_state_at(coarse, fine, step: int, lrate: float = 5e-4,
                   lrate_decay: int = 250,
                   grid_lrate: Optional[float] = None) -> TrainState:
    """A TrainState over existing fields with a fresh Adam (``grid_lrate``
    as in TrainState): ``step`` and the schedule's ``count`` continue at
    ``step``, Adam's own count and moments restart (a restarted Adam at
    count ``step`` would lose its bias correction and shrink the first
    updates right when the new parameters need to train)."""
    state = TrainState(coarse, fine, lrate, lrate_decay, grid_lrate)
    state.step = state.count = int(step)
    return state
