"""Checkpoint interop between the JAX package and the port: .tar both ways,
the JAX native .ckpt.npz into the port, and the resume rules. Weights must
cross bit for bit (the .tar stores the same fp32 values, transposed)."""

import os

import jax
import numpy as np
import pytest
import torch

from nerf_shared_tpu.config import config_parser as jax_parser
from nerf_shared_tpu.factory import get_train_state
from nerf_shared_tpu.utils import checkpoints as jckpt
from nerf_shared_tpu_torch.config import config_parser as torch_parser
from nerf_shared_tpu_torch.models.nerf import NeRF, params_from_jax
from nerf_shared_tpu_torch.factory import nerf_configs
from nerf_shared_tpu_torch.utils import checkpoints as tckpt

ARGV = ["--netdepth", "6", "--netwidth", "16", "--netdepth_fine", "6",
        "--netwidth_fine", "24", "--multires", "4", "--multires_views", "2",
        "--N_importance", "8", "--use_viewdirs", "--expname", "x"]


@pytest.fixture(scope="module")
def jax_state():
    state = get_train_state(jax_parser().parse_args(ARGV))
    return state, jax.device_get(state.params)


def _models():
    ccfg, fcfg = nerf_configs(torch_parser().parse_args(ARGV))
    return NeRF(ccfg), NeRF(fcfg)


def _assert_sd_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_jax_tar_loads_strict_into_port(tmp_path, jax_state):
    state, params = jax_state
    path = str(tmp_path / "000007.tar")
    opt_flat = jckpt.adam_state_to_flat(jax.device_get(state.opt_state))
    jckpt.save_tar(path, params, opt_flat, 7)
    coarse_sd, fine_sd, step = tckpt.load_tar(path)
    assert step == 7
    coarse, fine = _models()
    coarse.load_state_dict(coarse_sd, strict=True)
    fine.load_state_dict(fine_sd, strict=True)
    _assert_sd_equal(coarse.state_dict(), params_from_jax(params["coarse"]))
    _assert_sd_equal(fine.state_dict(), params_from_jax(params["fine"]))


def test_port_tar_loads_back_through_jax(tmp_path, jax_state):
    _, params = jax_state
    coarse, fine = _models()
    coarse.load_state_dict(params_from_jax(params["coarse"]))
    fine.load_state_dict(params_from_jax(params["fine"]))
    path = str(tmp_path / "000003.tar")
    tckpt.save_tar(path, coarse.state_dict(), fine.state_dict(), 3)
    back, opt_flat, step = jckpt.load_tar(path, params)
    assert step == 3 and opt_flat is None
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_coarse_only_tar_round_trip(tmp_path, jax_state):
    _, params = jax_state
    coarse, _ = _models()
    path = str(tmp_path / "000001.tar")
    tckpt.save_tar(path, coarse.state_dict(), None, 1)
    coarse_sd, fine_sd, _ = tckpt.load_tar(path)
    assert fine_sd is None
    _assert_sd_equal(coarse_sd, coarse.state_dict())


def test_jax_native_npz_reaches_the_same_params(tmp_path, jax_state):
    state, params = jax_state
    path = str(tmp_path / "000009.ckpt.npz")
    jckpt.save_native(path, params,
                      jckpt.adam_state_to_flat(jax.device_get(state.opt_state)), 9)
    coarse_sd, fine_sd, step = tckpt.load_native(path)
    assert step == 9
    _assert_sd_equal(coarse_sd, params_from_jax(params["coarse"]))
    _assert_sd_equal(fine_sd, params_from_jax(params["fine"]))
    coarse, fine = _models()
    coarse.load_state_dict(coarse_sd, strict=True)
    fine.load_state_dict(fine_sd, strict=True)


def test_resume_rules(tmp_path, jax_state):
    _, params = jax_state
    expdir = tmp_path / "x"
    jckpt.save_checkpoints(str(tmp_path), "x", get_train_state(
        jax_parser().parse_args(ARGV)), 5, fmt="both")
    coarse, fine = _models()
    tckpt.save_tar(str(expdir / "000010.tar"), coarse.state_dict(),
                   fine.state_dict(), 10)
    args = torch_parser().parse_args(ARGV + ["--basedir", str(tmp_path)])
    names = [os.path.basename(p) for p in tckpt.find_checkpoints(
        args.basedir, args.expname)]
    assert names == ["000005.ckpt.npz", "000005.tar", "000010.tar"]
    assert tckpt.load_checkpoint(args)[2] == 10          # newest wins
    args.ft_path = str(expdir / "000005.ckpt.npz")
    # ft_path overrides; the file holds the fresh state's global step, 0
    coarse_sd, _, step = tckpt.load_checkpoint(args)
    assert step == 0
    _assert_sd_equal(coarse_sd, params_from_jax(params["coarse"]))
    args.no_reload = True
    assert tckpt.load_checkpoint(args) == (None, None, 0)


# --- training checkpoints: Adam state both ways -------------------------------


def _trained_states(n_steps=2, seed=0):
    """A JAX TrainState and a port TrainState on the same weights after
    the same n_steps Adam updates (seeded numpy gradients), so both carry
    non-zero moments and count n_steps."""
    from nerf_shared_tpu_torch.factory import get_train_state as t_get_train_state

    args = jax_parser().parse_args(ARGV)
    jstate = get_train_state(args)
    tstate = t_get_train_state(torch_parser().parse_args(ARGV), "cpu")
    params = jax.device_get(jstate.params)
    with torch.no_grad():
        for branch, m in tstate.branches():
            m.load_state_dict(params_from_jax(params[branch]))
    rng = np.random.default_rng(seed)
    for _ in range(n_steps):
        grads = jax.tree_util.tree_map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        jstate = jstate.apply_gradients(jax.tree_util.tree_map(np.asarray, grads))
        for branch, m in tstate.branches():
            g = params_from_jax(grads[branch])
            for k, p in m.named_parameters():
                p.grad = g[k].clone()
        tstate.apply_gradients()
    return jstate, tstate


def _adam_by_name(tstate):
    """(branch, name) -> (exp_avg, exp_avg_sq) of a port TrainState."""
    out = {}
    for branch, m in tstate.branches():
        for k, p in m.named_parameters():
            st = tstate.optimizer.state[p]
            out[(branch, k)] = (st["exp_avg"], st["exp_avg_sq"])
    return out


def _assert_adam_matches_jax(tstate, jstate, atol, rtol=0.0):
    part = jckpt._adam_parts(jax.device_get(jstate.opt_state))[0]
    assert tstate.count == int(part.count)
    got = _adam_by_name(tstate)
    for branch in ("coarse", "fine"):
        mu, nu = params_from_jax(part.mu[branch]), params_from_jax(part.nu[branch])
        for k in mu:
            torch.testing.assert_close(got[(branch, k)][0], mu[k], rtol=rtol, atol=atol)
            torch.testing.assert_close(got[(branch, k)][1], nu[k], rtol=rtol, atol=atol)


@pytest.mark.parametrize("fmt", ["native", "tar"])
def test_jax_adam_state_resumes_in_the_port(tmp_path, fmt):
    """A JAX checkpoint with moments -> the port's restore: weights and
    moments bit for bit (same fp32 values, transposed), count and step."""
    from nerf_shared_tpu_torch.factory import get_train_state as t_get_train_state

    jstate, _ = _trained_states()
    jckpt.save_checkpoints(str(tmp_path), "x", jstate, 2, fmt=fmt)
    args = torch_parser().parse_args(ARGV + ["--basedir", str(tmp_path)])
    tstate = t_get_train_state(args, "cpu")
    assert tckpt.restore_train_state(tstate, args) == 2
    assert tstate.step == 2
    params = jax.device_get(jstate.params)
    _assert_sd_equal(tstate.coarse.state_dict(), params_from_jax(params["coarse"]))
    _assert_sd_equal(tstate.fine.state_dict(), params_from_jax(params["fine"]))
    _assert_adam_matches_jax(tstate, jstate, atol=0)


@pytest.mark.parametrize("fmt", ["native", "tar"])
def test_port_adam_state_resumes_in_jax(tmp_path, fmt):
    """The port's save_checkpoints -> the JAX load_checkpoint: weights and
    moments bit for bit, count and step; and the two states' Adam after the
    same updates agree (1e-5 relative + 1e-7, about one fp32 ulp of the
    unit-scale gradients: torch and optax round the moment updates in other
    places)."""
    jstate, tstate = _trained_states()
    _assert_adam_matches_jax(tstate, jstate, atol=1e-7, rtol=1e-5)
    paths = tckpt.save_checkpoints(str(tmp_path), "x", tstate, 2, fmt=fmt)
    assert [os.path.basename(p) for p in paths] == [
        "000002.ckpt.npz" if fmt == "native" else "000002.tar"]
    fresh = get_train_state(jax_parser().parse_args(ARGV))
    args = jax_parser().parse_args(ARGV + ["--basedir", str(tmp_path)])
    loaded, start = jckpt.load_checkpoint(fresh, args)
    assert start == 2 and int(loaded.step) == 2
    back = tstate.__class__.__new__(tstate.__class__)
    back.coarse, back.fine, back.optimizer, back.count = (
        tstate.coarse, tstate.fine, tstate.optimizer, tstate.count)
    _assert_adam_matches_jax(back, loaded, atol=0)
    params = jax.device_get(loaded.params)
    _assert_sd_equal(tstate.coarse.state_dict(), params_from_jax(params["coarse"]))


def test_file_without_adam_state_resumes_with_a_fresh_adam(tmp_path):
    """As the JAX load_checkpoint: weights and global step restored, Adam
    at count 0 (the learning rate restarts at --lrate)."""
    from nerf_shared_tpu_torch.factory import get_train_state as t_get_train_state

    _, tstate = _trained_states()
    tckpt.save_tar(str(tmp_path / "x" / "000004.tar"), tstate.coarse.state_dict(),
                   tstate.fine.state_dict(), 4)
    args = torch_parser().parse_args(ARGV + ["--basedir", str(tmp_path)])
    fresh = t_get_train_state(args, "cpu")
    assert tckpt.restore_train_state(fresh, args) == 4
    assert fresh.step == 4 and fresh.count == 0 and not fresh.optimizer.state
    assert fresh.lr() == fresh.lrate
    _assert_sd_equal(fresh.coarse.state_dict(), tstate.coarse.state_dict())
    jstate = get_train_state(jax_parser().parse_args(ARGV))
    loaded, start = jckpt.load_checkpoint(
        jstate, jax_parser().parse_args(ARGV + ["--basedir", str(tmp_path)]))
    part = jckpt._adam_parts(jax.device_get(loaded.opt_state))[0]
    assert start == 4 and int(part.count) == 0


def test_save_checkpoints_refuses_unknown_formats(tmp_path):
    _, tstate = _trained_states(n_steps=0)
    with pytest.raises(ValueError, match="format"):
        tckpt.save_checkpoints(str(tmp_path), "x", tstate, 0, fmt="npz")
    paths = tckpt.save_checkpoints(str(tmp_path), "x", tstate, 0, fmt="both")
    assert [os.path.basename(p) for p in paths] == ["000000.ckpt.npz", "000000.tar"]
