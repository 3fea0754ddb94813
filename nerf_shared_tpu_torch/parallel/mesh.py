"""The mesh of a run: ``--mesh_shape`` checked against the world the
launcher started, and the process groups of a 2-D ("data", "model") mesh.

Counterpart of ``nerf_shared_tpu/parallel/mesh.py:make_mesh``. The JAX
package builds a device mesh inside one process and, with no
``--mesh_shape``, spreads the batch over every visible device. The port
runs one process per card under torchrun, so the mesh is the world:

- ``make_mesh``: the data-parallel mesh of the trainer and of the render
  and export entry points. The first axis is "data" and must equal
  ``WORLD_SIZE``; a further axis > 1 raises (tensor parallelism is
  ``parallel/tensor.py``, which no entry point reads, as in JAX); a
  product > 1 in a process no launcher started raises and says how to
  launch it; no ``--mesh_shape``: the whole world on the data axis (one
  rank in a plain run, whatever cards the machine has).
- ``make_groups``: the ("data", "model") process groups of a
  ``--mesh_shape D M`` over a world of D·M ranks, rank = d·M + m (the
  row-major device order of JAX's ``devices.reshape(mesh_shape)``), for
  ``parallel/tensor.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch.distributed as dist

from nerf_shared_tpu_torch.parallel.distributed import World


def _shape_str(shape) -> str:
    return " ".join(map(str, shape))


def make_mesh(mesh_shape: Optional[Sequence[int]], world: World) -> World:
    """``world`` once ``mesh_shape`` is checked against it (see the module
    docstring); raises NotImplementedError or ValueError otherwise."""
    if not mesh_shape:
        return world
    shape = tuple(int(s) for s in mesh_shape)
    if any(s > 1 for s in shape[1:]):
        raise NotImplementedError(
            f"--mesh_shape {_shape_str(shape)}: the trainer and the render and "
            "export entry points shard over 'data' only; tensor parallelism over "
            "a 'model' axis is parallel/tensor.py (make_tp_apply), which no entry "
            "point reads, as in the JAX package")
    n = int(np.prod(shape))
    if n > 1 and not world.launched:
        raise ValueError(
            f"--mesh_shape {_shape_str(shape)} asks for {n} data-parallel "
            "ranks, but no launcher started this process: run it as "
            f"torchrun --nproc_per_node {n} -m nerf_shared_tpu_torch.apps.train ...")
    if shape[0] != world.size:
        raise ValueError(
            f"--mesh_shape {_shape_str(shape)}: the data axis ({shape[0]}) "
            f"must equal the launcher's WORLD_SIZE ({world.size})")
    return world


@dataclasses.dataclass(frozen=True)
class MeshGroups:
    """This rank's place on a ("data", "model") mesh: its coordinates, the
    axes' sizes and the process group along each axis (None on an axis of
    one rank, where nothing is exchanged)."""

    world: World
    data_size: int
    model_size: int
    data_rank: int
    model_rank: int
    data_group: Any = None
    model_group: Any = None


def make_groups(mesh_shape: Sequence[int], world: World) -> MeshGroups:
    """The process groups of ``mesh_shape`` = (D,) or (D, M) over ``world``
    (D·M ranks). Every rank creates every group, in one order, as
    ``torch.distributed.new_group`` requires."""
    shape = tuple(int(s) for s in mesh_shape) + (1,) * (2 - len(mesh_shape))
    if len(shape) != 2:
        raise ValueError(f"mesh_shape {_shape_str(mesh_shape)}: (data) or (data, model)")
    D, M = shape
    if D * M != world.size:
        raise ValueError(f"mesh_shape {_shape_str(shape)} needs {D * M} ranks; the "
                         f"world has {world.size}")
    d, m = divmod(world.rank, M)
    data_group = model_group = None
    if world.launched and world.size > 1:
        for dd in range(D):
            g = dist.new_group([dd * M + mm for mm in range(M)])
            if dd == d and M > 1:
                model_group = g
        for mm in range(M):
            g = dist.new_group([dd * M + mm for dd in range(D)])
            if mm == m and D > 1:
                data_group = g
    return MeshGroups(world, D, M, d, m, data_group, model_group)
