"""Row gather (kernel P1) and row scatter-add (kernel P2) of a feature table,
their plain versions, and the ``TableGather`` autograd pair.

Counterparts of ``pgather_kernel`` and ``pscat_kernel`` in
``benchmarks/scatter_probe.py``: P1 is ``jnp.take(table, idx, axis=0)``
and P2 ``jnp.zeros((T, w)).at[idx].add(upd)``, the gather and the
transposed scatter-add that XLA derives for it. Together they are the whole
table traffic of the grid model families (``models/hashgrid.py``,
``models/triplane.py``): every encode gathers through ``TableGather``
(forward P1, backward P2 into the table's gradient, none for the indices).

Tables are contiguous float32 [T, w], indices int32 [R] in [0, T) (the
callers clamp cells and mask hashes; the plain version asserts it and the
kernel clamps, so it never reads outside the table). On CPU tensors the
plain versions run; on CUDA tensors the kernels of ``csrc/gather.cu`` or an
error. P2 sums equal indices on chip before its atomics, which add in an
order that changes from run to run, so it agrees with its plain version to
fp32 rounding, not bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from nerf_shared_tpu_torch.ops.cuda import common

LAUNCHES = {"gather": 0, "scatter_add": 0}  # kernel launches of P1 and P2


def _check_idx(idx: torch.Tensor, device):
    if not isinstance(idx, torch.Tensor) or idx.dtype != torch.int32:
        raise TypeError(f"idx must be an int32 tensor, got {getattr(idx, 'dtype', idx)}")
    if idx.dim() != 1 or not idx.is_contiguous() or idx.device != device:
        raise ValueError(f"idx must be a contiguous 1-D tensor on {device}, got "
                         f"{tuple(idx.shape)} on {idx.device}")


def _assert_in_range(idx: torch.Tensor, T: int):
    if idx.numel() and not bool(((idx >= 0) & (idx < T)).all()):
        raise IndexError(f"row index out of range [0, {T}): "
                         f"[{int(idx.min())}, {int(idx.max())}]")


def plain_gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain version of P1: table[idx] -> [R, w]."""
    _assert_in_range(idx, table.shape[0])
    return table[idx.long()]


def plain_scatter_add_rows(idx: torch.Tensor, upd: torch.Tensor, T: int) -> torch.Tensor:
    """The plain version of P2: zeros [T, w] with upd[r] added at row idx[r]."""
    _assert_in_range(idx, T)
    out = torch.zeros((T, upd.shape[1]), dtype=upd.dtype, device=upd.device)
    return out.index_add_(0, idx.long(), upd)


_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out [R, w] = table [T, w] rows at idx [R] (int32): the plain version
    for CPU tensors, kernel P1 for CUDA tensors."""
    if table.device.type == "cpu":
        return plain_gather_rows(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows: no kernel for {table.device}")
    common.check_tensor(table, "table", (None, None), table.device)
    _check_idx(idx, table.device)
    T, w = table.shape
    if T < 1 or w < 1:
        raise ValueError(f"table has shape {(T, w)}, expected T >= 1 and w >= 1")
    out = torch.empty((idx.shape[0], w), dtype=torch.float32, device=table.device)
    fn = common.load("gather", _ARGS, "nstt_gather_rows")
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0], T, w,
                stream)
    common.check_launch(rc, "gather_rows (P1)")
    LAUNCHES["gather"] += 1
    return out


def scatter_add_rows(idx: torch.Tensor, upd: torch.Tensor, T: int) -> torch.Tensor:
    """out [T, w] = zeros with upd [R, w] added at rows idx [R] (int32),
    duplicates summed: the plain version for CPU tensors, kernel P2 for
    CUDA tensors."""
    if upd.device.type == "cpu":
        return plain_scatter_add_rows(idx, upd, T)
    if upd.device.type != "cuda":
        raise ValueError(f"scatter_add_rows: no kernel for {upd.device}")
    common.check_tensor(upd, "upd", (idx.shape[0] if idx.dim() == 1 else None, None),
                        upd.device)
    _check_idx(idx, upd.device)
    w = upd.shape[1]
    if T < 1 or w < 1:
        raise ValueError(f"output shape {(T, w)}: expected T >= 1 and w >= 1")
    out = torch.empty((T, w), dtype=torch.float32, device=upd.device)
    fn = common.load("gather", _ARGS, "nstt_scatter_add_rows")
    with torch.cuda.device(upd.device):
        stream = torch.cuda.current_stream(upd.device).cuda_stream
        rc = fn(idx.data_ptr(), upd.data_ptr(), out.data_ptr(), idx.shape[0], T, w,
                stream)
    common.check_launch(rc, "scatter_add_rows (P2)")
    LAUNCHES["scatter_add"] += 1
    return out


class TableGather(torch.autograd.Function):
    """table [T, w] rows at idx [R] (int32) -> [R, w]; forward P1, backward
    P2 into the table's gradient (the indices get none)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return gather_rows(table, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return scatter_add_rows(idx, g.contiguous(), ctx.n_rows), None


def table_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``TableGather.apply`` on a contiguous table and int32 indices of any
    shape: returns rows [*idx.shape, w]."""
    rows = TableGather.apply(table.contiguous(),
                             idx.reshape(-1).to(torch.int32).contiguous())
    return rows.reshape(*idx.shape, table.shape[1])


def bytes_moved(R: int, table_rows: int, w: int) -> int:
    """Bytes P1 or P2 must move: the R rows of w floats, R int32 indices,
    and ``table_rows`` rows of the table read once (P1: the distinct
    indices) or written once (P2: all T)."""
    return 4 * (R * w + R + table_rows * w)
