"""Data-parallel training over torch.distributed (``distributed``: the
world and its collectives; ``mesh``: ``--mesh_shape`` against the world)."""
