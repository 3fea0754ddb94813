"""The port's serving slice end to end on the CPU, against the JAX package.

A JAX-written .tar of seeded init weights on a generated blender scene is
rendered by the JAX package's ``render_only`` and by the port's
``build_eval_engine(--device cpu)``; then the port's HTTP service is stood
up on port 0 and every endpoint is driven over real HTTP, as
tests/test_serve.py does for the JAX service. ``netdepth 6`` puts the skip
(fixed at layer 4 by factory.nerf_configs) inside the network.
"""

import io
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from nerf_shared_tpu.apps.train import render_only as jax_render_only
from nerf_shared_tpu.config import config_parser as jax_parser
from nerf_shared_tpu.factory import create_nerf_models
from nerf_shared_tpu.utils.checkpoints import save_tar as jax_save_tar
from nerf_shared_tpu_torch.apps.serve import RenderService, make_server, serve_parser
from nerf_shared_tpu_torch.apps.train import build_eval_engine, render_only
from nerf_shared_tpu_torch.data.images import png_decode
from nerf_shared_tpu_torch.data.poses import pose_spherical
from nerf_shared_tpu_torch.utils.metrics import to8b
from tests.test_e2e import _write_config, _write_scene

SMALL = dict(netdepth=6, netdepth_fine=6, netwidth=32, netwidth_fine=32,
             N_samples=8, N_importance=16, multires=4, multires_views=2)


@pytest.fixture(scope="module")
def slice_cfg(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_slice"))
    datadir, logdir = os.path.join(root, "scene"), os.path.join(root, "logs")
    os.makedirs(datadir)
    _write_scene(datadir)
    cfg = _write_config(root, datadir, logdir, expname="slice", **SMALL)
    jargs = jax_parser().parse_args(["--config", cfg])
    coarse, fine = create_nerf_models(jargs, jax.random.PRNGKey(3))
    jax_save_tar(os.path.join(logdir, "slice", "000011.tar"),
                 {"coarse": jax.device_get(coarse.params),
                  "fine": jax.device_get(fine.params)}, None, 11)
    return cfg


def test_port_renders_what_jax_renders(slice_cfg):
    argv = ["--config", slice_cfg, "--render_only", "--render_test",
            "--chunk", "100"]
    _, want = jax_render_only(jax_parser().parse_args(argv), return_rgbs=True)
    targs = serve_parser().parse_args(argv + ["--device", "cpu"])
    outdir, got = render_only(targs, return_rgbs=True)
    assert got.shape == want.shape == (2, 16, 16, 3)
    # two fp32 MLP passes and an inverse-CDF resample between them: 1e-4
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # (the JAX run wrote its PNGs and video into the same directory first)
    assert {"000.png", "001.png"} <= set(os.listdir(outdir))
    with open(os.path.join(outdir, "000.png"), "rb") as f:
        np.testing.assert_array_equal(png_decode(f.read()), to8b(got[0]))


def test_cuda_default_raises_without_a_card(slice_cfg, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = serve_parser().parse_args(["--config", slice_cfg])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_eval_engine(args)


@pytest.mark.parametrize("flag,value", [
    ("--ema_decay", "0.999"), ("--barf_anneal", "100"), ("--train_occ", "True"),
    ("--refine_poses", "True"), ("--appearance", "True"),
    ("--proposal", "True"), ("--loss_sampling", "True"),
    ("--precision", "bf16"), ("--mesh_shape", "2"), ("--mesh_shape", "1"),
])
def test_unported_flags_raise(slice_cfg, flag, value):
    """Flags the port does not carry raise; --barf_anneal, --refine_poses
    and --appearance (the pose slice), --ema_decay, --proposal and
    --loss_sampling (the proposal slice), --train_occ (the occupancy
    trainer's slice) and --precision bf16 (the bf16 slice) are ported and
    build the engine. --mesh_shape: a mesh of one builds the plain engine,
    and a mesh of more without a launcher raises saying how to launch it
    (the sharded engine under torchrun: tests/test_torch_parallel_render.py).
    The slice's checkpoint holds a full-size coarse network, which a
    --proposal engine (a 2x64 proposal coarse) cannot load: that case
    builds from the seeded init (--no_reload)."""
    extra = ["--no_reload"] if flag == "--proposal" else []
    args = serve_parser().parse_args(
        ["--config", slice_cfg, "--device", "cpu", flag, value] + extra)
    if flag in ("--barf_anneal", "--refine_poses", "--appearance", "--ema_decay",
                "--proposal", "--loss_sampling", "--train_occ", "--precision") or (
            flag, value) == ("--mesh_shape", "1"):
        eng = build_eval_engine(args)
        assert eng.engine_name == "dense"
        assert eng.renderer.cfg.proposal == (flag == "--proposal")
        assert eng.renderer.cfg.precision == (value if flag == "--precision" else "fp32")
        return
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        build_eval_engine(args)


@pytest.fixture(scope="module")
def served(slice_cfg):
    args = serve_parser().parse_args(
        ["--config", slice_cfg, "--device", "cpu", "--chunk", "256",
         "--port", "0"])
    service = RenderService(args)
    server = make_server(service, "127.0.0.1", 0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    host, port = server.server_address[:2]
    yield service, f"http://{host}:{port}"
    server.shutdown()
    server.server_close()


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_health_and_info(served):
    _, base = served
    code, _, body = _get(base + "/health")
    assert code == 200 and json.loads(body) == {"status": "ok", "step": 11}
    info = json.loads(_get(base + "/info")[2])
    assert info["engine"] == "dense" and info["device"] == "cpu"
    assert (info["height"], info["width"], info["n_devices"]) == (16, 16, 1)


def test_render_get_png_matches_post_npy(served):
    service, base = served
    code, ctype, body = _get(base + "/render?theta=30&phi=-20&radius=4")
    assert code == 200 and ctype == "image/png"
    png = png_decode(body)
    assert png.shape == (16, 16, 3)
    c2w = pose_spherical(30.0, -20.0, 4.0)
    code, ctype, body = _post(base + "/render", {"c2w": c2w.tolist(),
                                                "fmt": "npy"})
    assert code == 200 and ctype == "application/octet-stream"
    frame = np.load(io.BytesIO(body))
    assert frame.shape == (16, 16, 3) and np.isfinite(frame).all()
    np.testing.assert_array_equal(to8b(frame), png)
    np.testing.assert_allclose(frame, service.render_c2w(c2w), atol=0)


def test_errors_are_400_and_404(served):
    _, base = served
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(base + "/render", {"c2w": [[1.0, 0.0], [0.0, 1.0]]})
    assert exc.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(base + "/render", {})
    assert exc.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(base + "/nope")
    assert exc.value.code == 404


def test_metrics_counts_frames(served):
    service, base = served
    before = service._frames
    _get(base + "/render?theta=0&fmt=npy")
    code, ctype, body = _get(base + "/metrics")
    assert code == 200 and ctype.startswith("text/plain")
    text = body.decode()
    assert f"nerf_render_frames_total {before + 1}" in text
    assert 'nerf_render_latency_seconds{quantile="0.5"}' in text
