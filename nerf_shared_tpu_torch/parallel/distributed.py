"""Joining a torch.distributed world, and the collectives of data-parallel
training.

Counterpart of ``nerf_shared_tpu/parallel/distributed.py`` (``initialize``)
and of the collectives the JAX step emits from ``shard_map``
(``train/step.py``, ``train/occ_train.py``): there a ``psum``/``pmean`` over
the mesh's "data" axis, here one process per card (torchrun) and NCCL on
the cards, gloo on the CPU.

- ``initialize(device)``: ``init_process_group`` from the launcher's
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR`` /
  ``MASTER_PORT`` as torchrun sets them) or from an explicit
  ``init_method`` (a ``file://`` store); without either a no-op that says
  so, as the JAX version is on one host. The rank's card is
  ``cuda:{LOCAL_RANK}``.
- ``broadcast_state``: rank 0's parameters, Adam moments, EMA shadow and
  loss map to every rank (after init or a resume).
- ``all_reduce_grads``: the mean gradient over the ranks, every parameter
  group (net, grid, pose, appearance) in one flat buffer, before Adam.
- ``all_reduce_mean`` / ``all_reduce_sum``: the step's aux values and the
  loss map's deltas.
- ``shard_rows`` / ``gather_rows``: a sharded render's or probe's rows,
  the counterpart of ``in_specs=P("data")`` / ``out_specs=P("data")``: the
  rows padded to a multiple of the world by repeating the last one, rank
  r's contiguous slice, and every rank's slice gathered back and trimmed.

With one rank every collective is skipped or exact (a sum over one rank,
divided by 1), so the world-size-1 step is the unsharded step bit for bit.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

# the launcher variables that say a process belongs to a world
LAUNCH_ENV = ("RANK", "WORLD_SIZE")
_GOLDEN = 0x9E3779B97F4A7C15


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in the data-parallel world: ``rank`` of
    ``size``, its card ``device``; ``launched`` when a process group exists."""

    rank: int = 0
    size: int = 1
    device: str = "cpu"
    launched: bool = False
    # this World's ``initialize`` created the process group (``shutdown``
    # destroys only such a group; an adopted one stays its maker's)
    owner: bool = False

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def launched_by_env() -> bool:
    """Whether a launcher (torchrun) started this process into a world."""
    return all(k in os.environ for k in LAUNCH_ENV)


def _device_for(device: str) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    return str(dev)


def initialize(device: str = "cuda", init_method: Optional[str] = None) -> World:
    """Join the launcher's world (NCCL for a CUDA ``device``, gloo for the
    CPU) and return it; an existing process group is adopted as it is.
    Without a launcher's environment and without ``init_method``: a
    single-process World, with a notice."""
    kind = torch.device(device).type
    if dist.is_available() and dist.is_initialized():
        return World(dist.get_rank(), dist.get_world_size(), _device_for(device), True)
    if init_method is None and not launched_by_env():
        print("torch.distributed not initialized (no launcher environment: "
              f"{', '.join(LAUNCH_ENV)}); single-process")
        return World(0, 1, _device_for(device), False)
    rank = int(os.environ.get("RANK", 0))
    size = int(os.environ.get("WORLD_SIZE", 1))
    dev = _device_for(device)
    if kind == "cuda":
        torch.cuda.set_device(torch.device(dev))
    dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                            init_method=init_method or "env://", rank=rank,
                            world_size=size)
    print(f"torch.distributed: rank {rank} of {size} on {dev} ({dist.get_backend()})")
    return World(rank, size, dev, True, owner=True)


def shutdown(world: Optional[World]) -> None:
    """Destroy the process group ``initialize`` created for ``world`` (a
    no-op for one process and for an adopted group)."""
    if world is not None and world.owner and dist.is_initialized():
        dist.destroy_process_group()


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s draws: rank 0 keeps ``seed`` (the
    unsharded run's), rank r > 0 folds r in (the counterpart of
    ``fold_in(key, axis_index)``)."""
    if rank == 0:
        return int(seed)
    return (int(seed) + rank * _GOLDEN) % (1 << 64)


def barrier(world: World) -> None:
    if world.launched and world.size > 1:
        dist.barrier()


def _flat_apply(tensors: List[torch.Tensor], op) -> None:
    """``op`` on one flat buffer holding ``tensors``, copied back in place."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    op(flat)
    for t, piece in zip(tensors, torch.split(flat, [t.numel() for t in tensors])):
        t.copy_(piece.view_as(t))


def _optimizer_tensors(state) -> List[torch.Tensor]:
    """Every parameter, then every tensor of its Adam state but the count."""
    out = list(state.parameters()) + list(state.aux.values())
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            for k, v in state.optimizer.state.get(p, {}).items():
                if k != "step" and isinstance(v, torch.Tensor) and v.device == p.device:
                    out.append(v)
    return out


@torch.no_grad()
def broadcast_state(state, world: World) -> None:
    """Rank 0's fields, per-image groups, Adam moments, EMA shadow and loss
    map on every rank, in place (after init or a resume, so every rank
    starts from one state)."""
    if world.size == 1:
        return
    tensors = _optimizer_tensors(state)
    if state.ema is not None:
        tensors += [t for b in sorted(state.ema) for t in state.ema[b].values()]
    if state.loss_map is not None:
        tensors.append(state.loss_map)
    _flat_apply(tensors, lambda flat: dist.broadcast(flat, src=0))


def _reduced_mean(world: World):
    def op(flat):
        if world.launched:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM)
            flat.div_(world.size)
    return op


@torch.no_grad()
def all_reduce_grads(state, world: World) -> None:
    """Every parameter group's .grad replaced by its mean over the ranks
    (one flat buffer, one all-reduce), before Adam."""
    grads = [p.grad for group in state.optimizer.param_groups
             for p in group["params"] if p.grad is not None]
    _flat_apply(grads, _reduced_mean(world))


@torch.no_grad()
def all_reduce_mean(values: Dict[str, torch.Tensor], world: World) -> Dict[str, torch.Tensor]:
    """The mean over the ranks of each scalar of ``values`` (one all-reduce)."""
    keys = sorted(values)
    flat = torch.stack([values[k].detach().float().reshape(()) for k in keys])
    _reduced_mean(world)(flat)
    return {k: flat[i] for i, k in enumerate(keys)}


@torch.no_grad()
def all_reduce_sum(t: torch.Tensor, world: World) -> torch.Tensor:
    """The sum over the ranks of ``t``, in place."""
    if world.launched:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def shard_rows(rows: torch.Tensor, world: Optional[World]) -> torch.Tensor:
    """Rank r's contiguous slice of ``rows`` [n, ...] padded to a multiple of
    the world size by repeating the last row (JAX's pad before a
    ``P("data")`` split, ``parallel/render.py``). One rank: ``rows`` itself."""
    if world is None or world.size == 1:
        return rows
    n = rows.shape[0]
    m = -(-n // world.size)
    pad = m * world.size - n
    if pad:
        rows = torch.cat([rows, rows[-1:].expand((pad,) + tuple(rows.shape[1:]))])
    return rows[world.rank * m:(world.rank + 1) * m]


def _all_gather_rows(local: torch.Tensor, size: int, group=None) -> torch.Tensor:
    """Every rank's ``local`` [m, ...] (equal shapes) concatenated in rank
    order: ``all_gather_into_tensor`` on NCCL, ``all_gather`` on gloo.
    Booleans cross as uint8."""
    t = local.contiguous()
    as_bool = t.dtype == torch.bool
    if as_bool:
        t = t.to(torch.uint8)
    if dist.get_backend(group) == "nccl":
        out = torch.empty((size * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, t, group=group)
    else:
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t, group=group)
        out = torch.cat(parts)
    return out.bool() if as_bool else out


def gather_rows(local: torch.Tensor, n: int, world: Optional[World]) -> torch.Tensor:
    """The rows [n, ...] of which each rank holds its ``shard_rows`` slice
    ``local``, on every rank (the counterpart of ``out_specs=P("data")``).
    One rank: ``local`` itself, no collective, so a world of one is the
    unsharded result bit for bit."""
    if world is None or world.size == 1:
        return local
    return _all_gather_rows(local, world.size)[:n]
