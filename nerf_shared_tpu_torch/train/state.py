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

Under ``--model_type mipnerf`` the schedule is mip-NeRF's instead
(``MipSchedule``: log-linear from ``lrate`` to ``lr_final`` over
``max_steps``, times a delay that rises from ``delay_mult`` to 1 over the
first ``delay_steps`` along a quarter sine), at step k + 1 as mip-NeRF's
trainer counts its first update.

``fresh_state_at`` restarts Adam over new parameters (a triplane upsample)
while ``count`` continues: the schedule goes on, Adam's own step restarts at
0 with zeroed moments, so bias correction stays on.

With ``n_refine_poses`` / ``n_appearance`` (--refine_poses, --appearance)
the state also holds the per-image pose twists [n, 6]
(train/pose_refine.py) and the appearance gains and offsets [n, 3]
(train/appearance.py), each group with its own Adam rate (``pose_lrate``,
``appearance_lrate``) on the same decay, as the JAX package's "pose" and
"appearance" groups. They are the ``aux`` parameters, after the fields in
the optimizer's order.

Two pieces of non-learned device state ride along, as the JAX state's
``aux_state``: ``ema`` (--ema_decay), the shadow {"coarse", "fine": name ->
tensor} of the fields' parameters that eval renders read (``init_ema``,
``update_ema``: decay * e + (1 - decay) * p after each Adam update; the
pose twists and appearance are not averaged), and ``loss_map``
(--loss_sampling, train/loss_sampling.py). In the mixed hierarchy (a
proposal MLP coarse, a grid fine) ``group_label`` puts the fine tables in
the "grid" group and the proposal MLP in "net".

``sync_coarse_from_fine`` is the phase switch of the two-phase schedule
(--train_occ_until): the coarse branch takes the fine branch's parameters
and Adam state.
"""

from __future__ import annotations

import collections
import math
from typing import Optional

import torch

from nerf_shared_tpu_torch.models.hashgrid import HashGrid, HashGridConfig
from nerf_shared_tpu_torch.models.nerf import NeRF, NeRFConfig, torch_param_order
from nerf_shared_tpu_torch.models.triplane import Triplane, TriplaneConfig

GRID_KEYS = ("tables", "planes")   # parameters of the "grid" Adam group
# the per-image groups: aux parameter names (their native checkpoint keys
# with "/" for ".") and each group's label
AUX_GROUPS = {"pose_twists": "pose", "appearance.gain": "appearance",
              "appearance.offset": "appearance"}


def lr_at(lrate: float, lrate_decay: int, count: int) -> float:
    """Continuous exponential decay at schedule count ``count``."""
    return lrate * 0.1 ** (count / (lrate_decay * 1000))


class MipSchedule:
    """mip-NeRF's ``learning_rate_decay`` (``internal/utils.py``) at its
    published Blender recipe: the rate at ``step`` from ``lr_init``
    (``--lrate``)."""

    lr_final = 5e-6
    max_steps = 1_000_000
    delay_steps = 2500
    delay_mult = 0.01

    def lr(self, lr_init: float, step: int) -> float:
        delay = self.delay_mult + (1 - self.delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / self.delay_steps, 0.0), 1.0))
        t = min(max(step / self.max_steps, 0.0), 1.0)
        return delay * math.exp(math.log(lr_init) * (1 - t) + math.log(self.lr_final) * t)


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
                 grid_lrate: Optional[float] = None, aux=None,
                 pose_lrate: float = 1e-3, appearance_lrate: float = 1e-3,
                 schedule: Optional[MipSchedule] = None):
        self.coarse, self.fine = coarse, fine
        self.lrate, self.lrate_decay = float(lrate), lrate_decay
        self.schedule = schedule
        self.grid_lrate = None if grid_lrate is None else float(grid_lrate)
        # name (an AUX_GROUPS key) -> leaf tensor of the per-image groups
        self.aux = collections.OrderedDict(
            (k, aux[k]) for k in AUX_GROUPS if aux is not None and k in aux)
        self.step = 0
        self.count = 0
        self.ema = None
        self.loss_map = None
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
        for label, rate in (("pose", pose_lrate), ("appearance", appearance_lrate)):
            mine = [p for k, p in self.aux.items() if AUX_GROUPS[k] == label]
            if mine:
                groups.append({"params": mine, "label": label, "base_lr": float(rate)})
        self.optimizer = torch.optim.Adam(groups, lr=self.lrate,
                                          betas=(0.9, 0.999), eps=1e-8)

    @property
    def pose_twists(self) -> Optional[torch.Tensor]:
        return self.aux.get("pose_twists")

    @property
    def appearance(self) -> Optional[dict]:
        if "appearance.gain" not in self.aux:
            return None
        return {"gain": self.aux["appearance.gain"],
                "offset": self.aux["appearance.offset"]}

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

    def init_ema(self):
        """Start the EMA shadow at the fields' current parameters."""
        self.ema = {b: {k: v.detach().clone() for k, v in m.params().items()}
                    for b, m in self.branches()}

    @torch.no_grad()
    def update_ema(self, decay: float):
        """ema <- decay * ema + (1 - decay) * params, on the device."""
        shadow, live = [], []
        for b, m in self.branches():
            p = m.params()
            for k, e in self.ema[b].items():
                shadow.append(e)
                live.append(p[k])
        torch._foreach_mul_(shadow, decay)
        torch._foreach_add_(shadow, live, alpha=1.0 - decay)

    def lr(self) -> float:
        """The net group's rate at the current count."""
        return self.group_lr(self.lrate)

    def group_lr(self, base_lr: float) -> float:
        """A group's rate at the current count (module docstring)."""
        if self.schedule is None:
            return lr_at(base_lr, self.lrate_decay, self.count)
        return self.schedule.lr(base_lr, self.count + 1)

    def apply_gradients(self):
        """One Adam update at each group's lr(count) from the parameters'
        .grad."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.group_lr(group["base_lr"])
        self.optimizer.step()
        self.count += 1
        self.step += 1


@torch.no_grad()
def sync_coarse_from_fine(state: TrainState) -> TrainState:
    """Copy the fine branch's parameters and Adam state (``exp_avg``,
    ``exp_avg_sq``, ``step``) onto the coarse branch, in place: the switch
    of the two-phase schedule, where the hierarchical phase needs a coarse
    net that already describes the scene (the occupancy-gated phase trains
    the fine net only). Every copy is a distinct tensor, so no Adam update
    of one branch reaches the other. Coarse and fine must have the same
    architecture (the caller checks; a mismatch raises ValueError)."""
    if state.fine is None or state.coarse.cfg != state.fine.cfg:
        raise ValueError("sync_coarse_from_fine needs coarse and fine fields "
                         "of one architecture")
    coarse, fine = state.coarse.params(), state.fine.params()
    opt = state.optimizer.state
    for k, pc in coarse.items():
        pf = fine[k]
        pc.copy_(pf)
        if pf in opt:
            opt[pc] = {n: v.clone() for n, v in opt[pf].items()}
        else:
            opt.pop(pc, None)
    return state


def init_aux(n_refine_poses: int, n_appearance: int, device) -> dict:
    """Identity pose twists and appearance corrections as leaf tensors
    (AUX_GROUPS names); empty when both counts are 0."""
    from nerf_shared_tpu_torch.train.appearance import init_appearance
    from nerf_shared_tpu_torch.train.pose_refine import init_pose_twists

    aux = {}
    if n_refine_poses > 0:
        aux["pose_twists"] = init_pose_twists(n_refine_poses, device)
    if n_appearance > 0:
        for k, v in init_appearance(n_appearance, device).items():
            aux[f"appearance.{k}"] = v
    return {k: v.requires_grad_(True) for k, v in aux.items()}


def create_train_state(coarse_cfg, fine_cfg, device, seed: int = 0,
                       lrate: float = 5e-4, lrate_decay: int = 250,
                       grid_lrate: Optional[float] = None,
                       n_refine_poses: int = 0, pose_lrate: float = 1e-3,
                       n_appearance: int = 0,
                       appearance_lrate: float = 1e-3,
                       schedule: Optional[MipSchedule] = None) -> TrainState:
    """Seeded fields (one torch.Generator from ``seed``, coarse then fine)
    and a fresh Adam; the grid group's rate defaults to 2e-2 whenever a
    branch is a grid family. ``n_refine_poses`` / ``n_appearance`` > 0 add
    the identity pose twists / appearance corrections of that many images,
    each group with its own Adam rate; ``schedule`` replaces the decay
    (``MipSchedule``)."""
    g = torch.Generator().manual_seed(int(seed))
    coarse = make_model(coarse_cfg, device, g)
    fine = make_model(fine_cfg, device, g) if fine_cfg is not None else None
    if grid_lrate is None and any(c is not None and not isinstance(c, NeRFConfig)
                                  for c in (coarse_cfg, fine_cfg)):
        grid_lrate = 2e-2
    return TrainState(coarse, fine, lrate, lrate_decay, grid_lrate,
                      aux=init_aux(n_refine_poses, n_appearance, device),
                      pose_lrate=pose_lrate, appearance_lrate=appearance_lrate,
                      schedule=schedule)


def fresh_state_at(coarse, fine, step: int, lrate: float = 5e-4,
                   lrate_decay: int = 250,
                   grid_lrate: Optional[float] = None, aux=None,
                   pose_lrate: float = 1e-3,
                   appearance_lrate: float = 1e-3, ema: bool = False,
                   loss_map: Optional[torch.Tensor] = None) -> TrainState:
    """A TrainState over existing fields (and ``aux`` groups) with a fresh
    Adam (``grid_lrate`` as in TrainState): ``step`` and the schedule's
    ``count`` continue at ``step``, Adam's own count and moments restart (a
    restarted Adam at count ``step`` would lose its bias correction and
    shrink the first updates right when the new parameters need to
    train). ``loss_map`` carries over; with ``ema`` the shadow restarts at
    the fields' parameters (a triplane upsample changed their shapes), as
    in the JAX trainer."""
    state = TrainState(coarse, fine, lrate, lrate_decay, grid_lrate, aux=aux,
                       pose_lrate=pose_lrate, appearance_lrate=appearance_lrate)
    state.step = state.count = int(step)
    state.loss_map = loss_map
    if ema:
        state.init_ema()
    return state

