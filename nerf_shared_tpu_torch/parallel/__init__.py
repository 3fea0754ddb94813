"""Work over torch.distributed: ``distributed`` (the world, its collectives,
``shard_rows`` / ``gather_rows``), ``mesh`` (``--mesh_shape`` against the
world, the ("data", "model") process groups), ``render`` (frames split over
the ranks) and ``tensor`` (the MLP's width split over a model axis)."""
