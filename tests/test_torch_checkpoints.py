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
