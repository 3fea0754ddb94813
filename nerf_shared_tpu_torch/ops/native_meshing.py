"""ctypes bindings for the port's host marching-tetrahedra cell scan
(``csrc/host/meshing.cpp``).

Counterpart of ``nerf_shared_tpu/ops/native_meshing.py``. The library is
built at first use by ``g++ -O3 -march=native -fopenmp -fPIC -shared`` into
``build/nerf_shared_tpu_torch/libmeshing-<hash>.so``; the hash covers the
source, the flags and the CPU that ``-march=native`` resolves to, so an edit
(or another host) rebuilds it. The build writes a temporary file and
``os.replace``s it, so parallel processes never load a half-written
library. ops/meshing.py falls back to its numpy scan when the build fails,
unless asked to require this one.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host" / "meshing.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nerf_shared_tpu_torch"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-shared")

_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)
_lock = threading.Lock()
_libs: Dict[Path, Optional[ctypes.CDLL]] = {}


@functools.lru_cache(maxsize=None)
def _native_arch() -> str:
    """What ``-march=native`` means on this host (g++'s own answer)."""
    r = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                       capture_output=True, text=True, timeout=60)
    return " ".join(line.split()[-1] for line in r.stdout.splitlines()
                    if line.strip().startswith("-march="))


def library_path(build_dir: Optional[Path] = None) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_native_arch().encode())
    h.update(SOURCE.read_bytes())
    return Path(build_dir or BUILD_DIR) / f"libmeshing-{h.hexdigest()[:12]}.so"


def build(build_dir: Optional[Path] = None) -> Path:
    """Compile the library unless it is built; raises with g++'s output
    when the build fails."""
    path = library_path(build_dir)
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    r = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed building {SOURCE.name}:\n{r.stderr}")
    os.replace(tmp, path)
    return path


def load(build_dir: Optional[Path] = None) -> Optional[ctypes.CDLL]:
    """The loaded library (built on demand), or None when it cannot be
    built or loaded."""
    key = Path(build_dir or BUILD_DIR)
    with _lock:
        if key not in _libs:
            try:
                lib = ctypes.CDLL(str(build(key)))
                lib.mt_count_slabs.argtypes = [_F32P, ctypes.c_int, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_float, _I64P]
                lib.mt_fill.argtypes = [_F32P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_float, _I64P, _I64P, _I64P]
                lib.mt_count_slabs.restype = lib.mt_fill.restype = None
                _libs[key] = lib
            except (OSError, RuntimeError, subprocess.SubprocessError):
                _libs[key] = None
        return _libs[key]


def available(build_dir: Optional[Path] = None) -> bool:
    return load(build_dir) is not None


def mt_scan(values: np.ndarray, iso: float, build_dir: Optional[Path] = None):
    """Scan all cubes: (lo, hi) int64 arrays of length 3*T with the (min,
    max) lattice indices of the edge each triangle corner lies on, in
    triangle-corner order (the winding of the case tables)."""
    lib = load(build_dir)
    if lib is None:
        raise RuntimeError("the native meshing library is unavailable (g++ failed)")
    v = np.ascontiguousarray(values, np.float32)
    if v.ndim != 3:
        raise ValueError(f"need an [X, Y, Z] lattice, got shape {v.shape}")
    X, Y, Z = v.shape
    counts = np.zeros(max(Z - 1, 1), np.int64)
    vp = v.ctypes.data_as(_F32P)
    lib.mt_count_slabs(vp, X, Y, Z, ctypes.c_float(iso), counts.ctypes.data_as(_I64P))
    offsets = np.zeros_like(counts)
    np.cumsum(counts[:-1], out=offsets[1:])
    total = int(counts.sum())
    lo = np.empty(total * 3, np.int64)
    hi = np.empty(total * 3, np.int64)
    if total:
        lib.mt_fill(vp, X, Y, Z, ctypes.c_float(iso), offsets.ctypes.data_as(_I64P),
                    lo.ctypes.data_as(_I64P), hi.ctypes.data_as(_I64P))
    return lo, hi
