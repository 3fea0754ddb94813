"""nerf_shared_tpu_torch: the PyTorch + CUDA port of nerf_shared_tpu.

The JAX package beside it is the reference. This package imports torch and
nothing of JAX or of ``nerf_shared_tpu``; its kernels are hand-written CUDA
for Hopper (``csrc/``), built by nvcc at first use.
"""
