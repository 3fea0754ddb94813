"""Probe: gather / scatter / sort rates on the card, with the port's
kernels P1 (row gather) and P2 (row scatter-add).

Counterpart of ``benchmarks/scatter_probe.py`` (same flags, defaults and
one-JSON-line-per-row output): rows 1-6 are the PyTorch library calls that
compute what the JAX probe's XLA rows compute, rows 7-8 the hand-written
kernels of ``csrc/gather.cu`` with their largest difference from the
library call of the same function and their bytes bound (3.35 TB/s).

    python -m nerf_shared_tpu_torch.benchmarks.scatter_probe \
        [--rows 3145728 --T 65536 --width 16 --reps 5 --device cuda]

Times on the card are CUDA events around ``--reps`` calls queued behind a
spin kernel after a warm-up call (device time per call, the host's cost
kept off the clock); ``--device cpu`` (plain versions, host clock) is a
smoke run and says so on every row. The library calls here are yardsticks: the port
never calls them on its CUDA path.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from nerf_shared_tpu_torch.ops.cuda import gather

PEAK_BYTES = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)


def time_ms(fn, reps: int, device) -> float:
    """Milliseconds per call of fn() after a warm-up call. On a card: CUDA
    events around ``reps`` calls queued behind a ~30 ms spin kernel, so the
    host's per-call cost stays off the clock while it enqueues ahead (the
    median of three such rounds). On the CPU: the median host time of
    ``reps`` calls."""
    fn()
    if device.type != "cuda":
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)
    torch.cuda.synchronize(device)
    ts = []
    for _ in range(3):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(50_000_000)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize(device)
        ts.append(a.elapsed_time(b) / reps)
    return statistics.median(ts)


def run(rows: int, T: int, width: int, reps: int = 5, device="cuda", out=print):
    """Run the eight rows; ``out`` gets each JSON line. Returns the rows as
    dicts."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("scatter_probe: no CUDA device (pass --device cpu for a "
                           "smoke run of the plain versions)")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    out(f"# device={name} rows={rows} T={T} width={width}")
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.standard_normal((T, width), np.float32)).to(device)
    idx = torch.from_numpy(rng.integers(0, T, rows).astype(np.int32)).to(device)
    upd = torch.from_numpy(rng.standard_normal((rows, width), np.float32)).to(device)
    results = []

    def row(label, fn, **kw):
        ms = time_ms(fn, reps, device)
        d = {"row": label, "ms": ms, "Mrows_per_s": rows / ms / 1e3, "device": name}
        d.update(kw)
        out(json.dumps(d))
        results.append(d)

    # 1. gather
    row("torch_index_select", lambda: torch.index_select(table, 0, idx))
    # 2. scatter-add, duplicate indices (t.at[i].add(u))
    row("torch_index_add_dup", lambda: table.index_add(0, idx, upd))
    # 3. scatter-set, unique indices (a permutation into a [rows, w] buffer)
    perm = torch.from_numpy(rng.permutation(rows).astype(np.int64)).to(device)
    buf = torch.zeros((rows, width), device=device)
    row("torch_index_copy_unique_perm", lambda: buf.index_copy(0, perm, upd))
    # 4. sort int32 keys
    row("torch_argsort", lambda: torch.argsort(idx))
    # 5. segment sum over sorted keys
    order = torch.argsort(idx)
    supd = upd[order]
    lengths = torch.bincount(idx.long(), minlength=T)
    row("torch_segment_sum_sorted",
        lambda: torch.segment_reduce(supd, "sum", lengths=lengths, axis=0))
    # 6. cumsum for rank-within-bucket (one radix pass, 256 buckets)
    oh = (idx[:, None] & 0xFF) == torch.arange(256, dtype=torch.int32, device=device)
    row("torch_cumsum_rank_256", lambda: torch.cumsum(oh.to(torch.int32), dim=0))
    del oh
    # 7-8. the port's kernels against the library call of the same function;
    # bounds: P1 reads the distinct rows its indices name, P2 writes all T
    distinct = int(torch.unique(idx).numel())
    want = torch.index_select(table, 0, idx)
    err = float((gather.gather_rows(table, idx) - want).abs().max()) if rows else 0.0
    row("p1_gather_rows", lambda: gather.gather_rows(table, idx), max_err=err,
        bound_ms=1e3 * gather.bytes_moved(rows, distinct, width) / PEAK_BYTES)
    want = torch.zeros((T, width), device=device).index_add_(0, idx, upd)
    err = float((gather.scatter_add_rows(idx, upd, T) - want).abs().max())
    row("p2_scatter_add_rows", lambda: gather.scatter_add_rows(idx, upd, T),
        max_err=err, max_abs=float(want.abs().max()),
        bound_ms=1e3 * gather.bytes_moved(rows, T, width) / PEAK_BYTES)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=3_145_728)  # 196608*16
    ap.add_argument("--T", type=int, default=1 << 16)
    ap.add_argument("--width", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", type=str, default="cuda")
    a = ap.parse_args(argv)
    return run(a.rows, a.T, a.width, a.reps, a.device,
               out=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
