"""The benchmark of the PyTorch + CUDA port (``nerf_shared_tpu_torch``)."""
