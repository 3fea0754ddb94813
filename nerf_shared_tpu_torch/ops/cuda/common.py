"""Build, load and guard the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface (``build/nerf_shared_tpu_torch/lib<name>-<hash>.so``)
and loaded with ``ctypes``. The build runs at first use, from the sources in
the checkout, one ``nvcc`` per source, all started together; the hash of the
sources and flags names the library, so an edit rebuilds it. Nothing here
runs at import time: importing the package needs neither ``nvcc`` nor a
card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence

import numpy as np
import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "nerf_shared_tpu_torch"
KERNELS = ("fused_mlp", "fused_render", "fused_mlp_bwd", "composite", "gather")
# no --use_fast_math: __sinf is wrong at the encoder's 2^9·|x| arguments
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}   # name -> nvcc's output (ptxas register use)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(path)


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile the named kernels that are not built yet, in parallel.
    Raises with nvcc's output when any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo, paths = {}, {}
    for name in names:
        path = _lib_path(name)
        paths[name] = path
        if not path.exists():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            todo[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, path)
    failed = []
    for name, (proc, tmp, path) in todo.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str, argtypes: Sequence, symbol: str) -> Callable:
    """The C entry ``symbol`` of kernel library ``name`` (built on demand)."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build([name])[name]))
        fn = getattr(_libs[name], symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def upload(array: np.ndarray, device) -> torch.Tensor:
    """A small host table (descriptor, encoder table) on ``device``. On a
    CUDA device the copy goes through pinned memory and does not block: a
    plain ``.to(device)`` from pageable memory synchronises the stream,
    which would stall the launch queue once per kernel call. The caching
    host allocator keeps the pinned block until the copy has run."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def check_launch(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def check_tensor(t: torch.Tensor, name: str, shape: Sequence, device):
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on
    ``device`` (a None entry in ``shape`` matches any size)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def pack8(rgb, disp, acc, depth):
    """The [N, 8] per-ray record the compositing kernels (B4, B5) write:
    r, g, b, disp, acc, depth, 0, 0."""
    zeros = torch.zeros_like(rgb[:, :2])
    return torch.cat([rgb, disp[:, None], acc[:, None], depth[:, None], zeros], -1)


def remat_grads(ctx, plain_fn, inputs, grad_outputs):
    """Backward of a kernel's autograd.Function: recompute the forward
    through its plain PyTorch version and differentiate that. ``inputs``
    are the Function's tensor arguments after its ``ctx.n_lead`` leading
    non-tensor ones. Returns one gradient per entry of ``inputs`` (None
    where none is needed)."""
    need = [i for i, t in enumerate(inputs)
            if t is not None and ctx.needs_input_grad[ctx.n_lead + i]]
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(i in need) if t is not None else None
                  for i, t in enumerate(inputs)]
        outs = plain_fn(*leaves)
        grads = torch.autograd.grad(
            outs, [leaves[i] for i in need], grad_outputs, allow_unused=True)
    out = [None] * len(inputs)
    for i, g in zip(need, grads):
        out[i] = g
    return out
