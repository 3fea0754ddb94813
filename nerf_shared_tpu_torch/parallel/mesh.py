"""The data-parallel mesh of a run: ``--mesh_shape`` checked against the
world the launcher started.

Counterpart of ``nerf_shared_tpu/parallel/mesh.py:make_mesh``. The JAX
package builds a device mesh inside one process and, with no
``--mesh_shape``, spreads the batch over every visible device. The port
runs one process per card under torchrun, so the mesh is the world:

- the first axis is "data" and must equal ``WORLD_SIZE``;
- a further axis > 1 (tensor parallelism) raises: not ported (ROADMAP
  A16b);
- a product > 1 in a process no launcher started raises and says how to
  launch it;
- no ``--mesh_shape``: the whole world on the data axis (one rank in a
  plain run, whatever cards the machine has).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from nerf_shared_tpu_torch.parallel.distributed import World


def make_mesh(mesh_shape: Optional[Sequence[int]], world: World) -> World:
    """``world`` once ``mesh_shape`` is checked against it (see the module
    docstring); raises NotImplementedError or ValueError otherwise."""
    if not mesh_shape:
        return world
    shape = tuple(int(s) for s in mesh_shape)
    if any(s > 1 for s in shape[1:]):
        raise NotImplementedError(
            f"--mesh_shape {' '.join(map(str, shape))}: a mesh axis after "
            "'data' (tensor parallelism) is not ported to "
            "nerf_shared_tpu_torch yet (ROADMAP A16b)")
    n = int(np.prod(shape))
    if n > 1 and not world.launched:
        raise ValueError(
            f"--mesh_shape {' '.join(map(str, shape))} asks for {n} data-parallel "
            "ranks, but no launcher started this process: run it as "
            f"torchrun --nproc_per_node {n} -m nerf_shared_tpu_torch.apps.train ...")
    if shape[0] != world.size:
        raise ValueError(
            f"--mesh_shape {' '.join(map(str, shape))}: the data axis ({shape[0]}) "
            f"must equal the launcher's WORLD_SIZE ({world.size})")
    return world
