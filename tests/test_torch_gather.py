"""Kernels P1 (row gather) and P2 (row scatter-add) of ops/cuda/gather.py
on the CPU, against the JAX package's probe kernels.

A CUDA kernel cannot run here, so these tests hold the plain versions and
the autograd pair around the launch:

- the plain P1 and P2 against the Pallas kernels of
  ``benchmarks/scatter_probe.py`` (``pgather_kernel``, ``pscat_kernel``) in
  interpret mode, rebuilt here exactly as the probe writes them (they are
  closures inside its ``main()``); P2 on indices unique within each block,
  which the Pallas body needs;
- both against ``jnp.take`` / ``.at[].add`` with duplicate indices;
- what the Pallas P2 does with duplicates inside one block (it keeps one
  of them, so it is not a scatter-add there; the port's P2 is);
- every width the kernels instantiate, and duplicate-heavy index patterns
  shaped like the grid paths' (runs of equal rows; repeats 128 rows apart);
- ``TableGather``'s gradient against autograd through plain indexing, the
  CPU dispatch and the input guards.

P1 is a copy, so it is held exactly; P2 sums in another order than XLA,
so to 1e-6 of the largest |entry|. The kernels themselves are held against
the plain versions on the card by chip_smoke.py (phase 8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from nerf_shared_tpu_torch.ops.cuda import gather


def _probe_gather(rows, T, width, CH):
    """The probe's P1 pallas_call (scatter_probe.py:104-118), interpreted."""

    def pgather_kernel(t_ref, i_ref, o_ref):
        o_ref[:] = t_ref[i_ref[:], :]

    def pgather(t, i):
        return pl.pallas_call(
            pgather_kernel,
            grid=(rows // CH,),
            in_specs=[
                pl.BlockSpec((T, width), lambda k: (0, 0), memory_space=pltpu.VMEM),
                pl.BlockSpec((CH,), lambda k: (k,), memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((CH, width), lambda k: (k, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((rows, width), jnp.float32),
            interpret=True,
        )(t, i)

    return pgather


def _probe_scatter(rows, T, width, CH):
    """The probe's P2 pallas_call (scatter_probe.py:134-152), interpreted."""

    def pscat_kernel(i_ref, u_ref, o_ref):
        @pl.when(pl.program_id(0) == 0)
        def _():
            o_ref[:] = jnp.zeros_like(o_ref)
        o_ref[i_ref[:], :] += u_ref[:]

    def pscat(i, u):
        return pl.pallas_call(
            pscat_kernel,
            grid=(rows // CH,),
            in_specs=[
                pl.BlockSpec((CH,), lambda k: (k,), memory_space=pltpu.VMEM),
                pl.BlockSpec((CH, width), lambda k: (k, 0), memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((T, width), lambda k: (0, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((T, width), jnp.float32),
            interpret=True,
        )(i, u)

    return pscat


def _case(rows, T, width, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((T, width)).astype(np.float32)
    idx = rng.integers(0, T, rows).astype(np.int32)
    upd = rng.standard_normal((rows, width)).astype(np.float32)
    return table, idx, upd


def _block_unique(rows, T, CH, seed=0):
    """Indices with no repeat inside any CH-row block (repeats across
    blocks): each block is a slice of its own permutation of [0, T)."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.permutation(T)[:CH] for _ in range(rows // CH)]
                          ).astype(np.int32)


def _scatter_tol(want):
    return 1e-6 * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("rows,T,width,CH", [(256, 64, 16, 128), (96, 40, 3, 32),
                                             (64, 8, 64, 64)])
def test_plain_p1_matches_probe_pallas_gather(rows, T, width, CH):
    table, idx, _ = _case(rows, T, width, seed=rows)
    want = _probe_gather(rows, T, width, CH)(jnp.asarray(table), jnp.asarray(idx))
    got = gather.plain_gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rows,T,width,CH", [(256, 160, 16, 128), (96, 40, 3, 32),
                                             (128, 64, 64, 64)])
def test_plain_p2_matches_probe_pallas_scatter_on_block_unique_indices(rows, T, width, CH):
    _, _, upd = _case(rows, T, width, seed=rows + 1)
    idx = _block_unique(rows, T, CH, seed=rows)
    want = np.asarray(_probe_scatter(rows, T, width, CH)(jnp.asarray(idx),
                                                         jnp.asarray(upd)))
    got = gather.plain_scatter_add_rows(torch.from_numpy(idx), torch.from_numpy(upd), T)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_scatter_tol(want))


# every width kernel P1 / P2 instantiates (1, 2, 4 a row a thread; 16, 64
# w / 4 lanes a row) and one the generic kernels take (3)
WIDTHS = (1, 2, 3, 4, 16, 64)


@pytest.mark.parametrize("rows,T,width", [(300, 17, 2), (512, 64, 16), (33, 1, 5),
                                          (1, 9, 64)] + [(777, 53, w) for w in WIDTHS])
def test_plain_p1_p2_match_jnp_with_duplicates(rows, T, width):
    table, idx, upd = _case(rows, T, width, seed=T)
    got = gather.plain_gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0)))
    want = np.asarray(jnp.zeros((T, width)).at[jnp.asarray(idx)].add(jnp.asarray(upd)))
    got = gather.plain_scatter_add_rows(torch.from_numpy(idx), torch.from_numpy(upd), T)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_scatter_tol(want))


def _jnp_pair(table, idx, upd, T):
    """jnp.take and the scatter-add XLA derives for its transpose."""
    want_rows = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0))
    want_sum = np.asarray(jnp.zeros((T, upd.shape[1])).at[jnp.asarray(idx)].add(
        jnp.asarray(upd)))
    return want_rows, want_sum


def _run_indices(rows, T, seed):
    """Indices in runs of equal values, the way a split level's fine pass
    gives them (consecutive samples of a ray in one cell): run lengths
    geometric with mean 4, values drawn from T."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < rows:
        out += [int(rng.integers(0, T))] * int(rng.geometric(0.25))
    return np.asarray(out[:rows], np.int32)


def _strided_indices(rows, T, seed, stride=128):
    """Equal indices ``stride`` rows apart, the vertex layout's [P, L, 8]
    order: point p's slot k repeats point p - 1's while both sit in one
    cell (runs of mean 3 over p), all slots distinct within a point."""
    rng = np.random.default_rng(seed)
    points = -(-rows // stride)
    slots = np.stack([rng.choice(T, stride, replace=False) for _ in range(points)])
    keep = rng.random(points) < 2 / 3
    for p in range(1, points):
        if keep[p]:
            slots[p] = slots[p - 1]
    return slots.reshape(-1)[:rows].astype(np.int32)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("pattern", ["runs", "strided"])
def test_plain_p1_p2_match_jnp_on_main_path_index_patterns(width, pattern):
    """Duplicate-heavy indices shaped like the grid paths': runs of equal
    rows (split levels, triplane planes), which P2's warp merge folds, and
    repeats 128 rows apart (vertex layout), which its tile merge folds."""
    rows, T = 2048, 300
    table, _, upd = _case(rows, T, width, seed=width + 11)
    idx = (_run_indices if pattern == "runs" else _strided_indices)(rows, T, seed=width)
    assert len(np.unique(idx)) < rows // 2
    want_rows, want_sum = _jnp_pair(table, idx, upd, T)
    got = gather.plain_gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want_rows)
    got = gather.plain_scatter_add_rows(torch.from_numpy(idx), torch.from_numpy(upd), T)
    np.testing.assert_allclose(got.numpy(), want_sum, rtol=0, atol=_scatter_tol(want_sum))


@pytest.mark.parametrize("width", WIDTHS)
def test_wrappers_take_the_plain_versions_on_cpu_tensors(width):
    """On CPU tensors gather_rows and scatter_add_rows are the plain
    versions, bit for bit, and launch nothing."""
    rows, T = 300, 29
    table, idx, upd = (torch.from_numpy(a) for a in _case(rows, T, width, seed=3))
    before = dict(gather.LAUNCHES)
    assert torch.equal(gather.gather_rows(table, idx), gather.plain_gather_rows(table, idx))
    assert torch.equal(gather.scatter_add_rows(idx, upd, T),
                       gather.plain_scatter_add_rows(idx, upd, T))
    assert gather.LAUNCHES == before


def test_probe_pallas_scatter_drops_duplicates_within_a_block():
    """The Pallas P2 body reads and writes each index once per block, so
    equal indices inside one block leave only one of their rows: against
    the scatter-add it misses by whole rows. With every block's indices
    unique it is exact. The port's P2 computes the scatter-add."""
    rows, T, width, CH = 256, 64, 16, 128
    _, idx, upd = _case(rows, T, width, seed=3)
    assert any(len(set(idx[k:k + CH])) < CH for k in range(0, rows, CH))
    add = np.asarray(jnp.zeros((T, width)).at[jnp.asarray(idx)].add(jnp.asarray(upd)))
    pallas = np.asarray(_probe_scatter(rows, T, width, CH)(jnp.asarray(idx),
                                                           jnp.asarray(upd)))
    assert np.abs(pallas - add).max() > 1.0
    ours = gather.plain_scatter_add_rows(torch.from_numpy(idx), torch.from_numpy(upd), T)
    np.testing.assert_allclose(ours.numpy(), add, rtol=0, atol=_scatter_tol(add))


def test_zero_rows():
    table = torch.randn(5, 3)
    idx = torch.zeros(0, dtype=torch.int32)
    assert gather.gather_rows(table, idx).shape == (0, 3)
    out = gather.scatter_add_rows(idx, torch.zeros(0, 3), 5)
    assert out.shape == (5, 3) and not out.any()


@pytest.mark.parametrize("shape", [(40,), (6, 7), (3, 4, 8)])
def test_table_gather_gradient_matches_plain_indexing(shape):
    """The autograd pair (P1 forward, P2 backward into the table) against
    autograd through table[idx]: rows exactly, the table gradient to fp32
    rounding; int32 indices of any shape, no gradient for them."""
    rng = np.random.default_rng(len(shape))
    T, w = 11, 4
    base = torch.from_numpy(rng.standard_normal((T, w)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, T, shape).astype(np.int32))
    cot = torch.from_numpy(rng.standard_normal(shape + (w,)).astype(np.float32))
    t1 = base.clone().requires_grad_(True)
    rows = gather.table_gather(t1, idx)
    (rows * cot).sum().backward()
    t2 = base.clone().requires_grad_(True)
    want = t2[idx.long()]
    (want * cot).sum().backward()
    torch.testing.assert_close(rows, want, rtol=0, atol=0)
    torch.testing.assert_close(t1.grad, t2.grad, rtol=1e-6, atol=1e-6)
    assert gather.LAUNCHES == {"gather": 0, "scatter_add": 0}


def test_plain_versions_assert_the_index_range():
    with pytest.raises(IndexError, match="out of range"):
        gather.plain_gather_rows(torch.zeros(4, 2), torch.tensor([0, 4], dtype=torch.int32))
    with pytest.raises(IndexError, match="out of range"):
        gather.plain_scatter_add_rows(torch.tensor([-1], dtype=torch.int32),
                                      torch.zeros(1, 2), 4)


def test_other_devices_raise():
    t = torch.zeros(4, 2, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        gather.gather_rows(t, torch.zeros(1, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        gather.scatter_add_rows(torch.zeros(1, dtype=torch.int32, device="meta"), t, 4)


def test_bytes_moved_counts_rows_indices_and_table():
    # the probe's shape: 3,145,728 rows of 16 floats from 65,536 rows
    assert gather.bytes_moved(3_145_728, 65_536, 16) == 4 * (
        3_145_728 * 16 + 3_145_728 + 65_536 * 16)


def test_ported_probe_runs_its_eight_rows_on_the_cpu():
    """The port's scatter_probe at a tiny size with the plain versions: the
    JAX probe's six library rows and the two kernel rows, each a JSON line,
    the kernel rows equal to their library calls."""
    import json

    from nerf_shared_tpu_torch.benchmarks import scatter_probe

    lines = []
    rows = scatter_probe.run(512, 64, 4, reps=1, device="cpu", out=lines.append)
    assert [r["row"] for r in rows] == [
        "torch_index_select", "torch_index_add_dup", "torch_index_copy_unique_perm",
        "torch_argsort", "torch_segment_sum_sorted", "torch_cumsum_rank_256",
        "p1_gather_rows", "p2_scatter_add_rows"]
    assert lines[0].startswith("# device=cpu") and len(lines) == 9
    assert [json.loads(line) for line in lines[1:]] == rows
    assert rows[6]["max_err"] == 0.0 and rows[7]["max_err"] <= 1e-5 * rows[7]["max_abs"]
