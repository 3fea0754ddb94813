"""The port stands alone: every module of nerf_shared_tpu_torch imports
with JAX made unimportable, no source of the port (nor chip_smoke.py)
imports jax or the JAX package, and the port's host C++ (the mesh cell
scan) is its own copy, built from its own tree. Flags still unported
raise in every entry point that reads them."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "nerf_shared_tpu_torch")


def _modules():
    names = ["nerf_shared_tpu_torch"]
    for info in pkgutil.walk_packages([PKG], prefix="nerf_shared_tpu_torch."):
        names.append(info.name)
    return sorted(names)


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_package_has_the_slice_modules():
    mods = set(_modules())
    for m in ("config", "data.images", "data.poses", "data.blender",
              "data.datasets", "ops.embedding", "ops.rays", "ops.sampling",
              "ops.compositing", "models.nerf", "ops.cuda.fused_mlp",
              "ops.cuda.fused_render", "render.renderer", "utils.checkpoints",
              "utils.metrics", "factory", "apps.train", "apps.serve",
              "ops.permute", "ops.cuda.fused_mlp_bwd", "train.state",
              "train.pipeline", "train.step", "utils.logging",
              "ops.cuda.composite", "render.gated", "render.occupancy",
              "render.froxels", "ops.cuda.gather", "models.hashgrid",
              "models.triplane", "benchmarks.scatter_probe", "data.llff",
              "data.deepvoxels", "data.linemod", "apps.eval_cli", "ops.se3",
              "train.pose_refine", "train.appearance", "apps.pose_estimation",
              "apps.pose_cli", "train.occ_train", "ops.meshing", "ops.native_meshing",
              "apps.mesh_cli", "benchmarks.fp32_digest", "parallel.distributed",
              "parallel.mesh", "utils.debug", "data.jpeg"):
        assert f"nerf_shared_tpu_torch.{m}" in mods, m


def test_every_module_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['nerf_shared_tpu'] = None\n"
        "import importlib\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None and (\n"
        "       m in ('jax', 'nerf_shared_tpu') or m.startswith('jax.')\n"
        "       or m.startswith('nerf_shared_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_sources_import_neither_jax_nor_the_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "") ==
              "__import__" and node.args and isinstance(node.args[0], ast.Constant)):
            names = [node.args[0].value]
        else:
            continue
        for n in names:
            root = n.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax", "nerf_shared_tpu"), \
                f"{path}:{node.lineno} imports {n}"


def test_native_meshing_builds_from_the_port_tree_only():
    """The cell scan is compiled from the port's csrc/host/meshing.cpp into
    the port's build directory: the mesh modules never name the JAX
    package's native/ directory, and the copy's code is the original's."""
    from nerf_shared_tpu_torch.ops import native_meshing

    assert str(native_meshing.SOURCE) == os.path.join(PKG, "csrc", "host", "meshing.cpp")
    assert native_meshing.library_path().parent == native_meshing.BUILD_DIR
    assert native_meshing.BUILD_DIR.parts[-2:] == ("build", "nerf_shared_tpu_torch")
    for mod in ("ops/native_meshing.py", "ops/meshing.py", "apps/mesh_cli.py"):
        with open(os.path.join(PKG, mod)) as f:
            assert "native/" not in f.read(), mod
    with open(os.path.join(REPO, "native", "meshing.cpp")) as f:
        original = f.read()
    with open(native_meshing.SOURCE) as f:
        copy = f.read()
    assert copy[copy.index("namespace {"):] == original[original.index("namespace {"):]


def test_train_occ_is_ported_and_mesh_shape_still_raises():
    """Every flag is ported: the not-ported table and its check are gone
    with the sharded renders and export. Without a launcher, 2 ranks raise
    in the trainer and in the mesh CLI, saying how to launch them (the
    sharded probe: tests/test_torch_parallel_render.py)."""
    from nerf_shared_tpu_torch.apps import mesh_cli, train
    from nerf_shared_tpu_torch.config import config_parser

    assert not hasattr(train, "_NOT_PORTED") and not hasattr(train, "check_ported")
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        train.train(config_parser().parse_args(["--device", "cpu", "--mesh_shape", "2"]))
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        mesh_cli.main(["--device", "cpu", "--mesh_shape", "2"])


def test_the_new_modules_default_to_the_card(monkeypatch):
    """parallel.distributed.initialize defaults to the card (NCCL); the
    trainer's --debug_nans / --multihost / --mesh_shape run on --device
    cuda unless asked for the CPU, and raise without a card."""
    import inspect

    import torch

    from nerf_shared_tpu_torch.apps import train
    from nerf_shared_tpu_torch.config import config_parser
    from nerf_shared_tpu_torch.parallel import distributed

    assert inspect.signature(distributed.initialize).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for flag in (["--debug_nans", "True"], ["--multihost", "True"], ["--mesh_shape", "1"]):
        args = config_parser().parse_args(flag)
        assert args.device == "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.train(args)


def test_precision_bf16_is_ported_everywhere_the_flag_is_read():
    """--precision bf16 reaches the render config through the factory (no
    entry point has a not-ported check left)."""
    from nerf_shared_tpu_torch.apps import train
    from nerf_shared_tpu_torch.config import config_parser
    from nerf_shared_tpu_torch.factory import get_renderer

    assert not hasattr(train, "_NOT_PORTED")
    args = config_parser().parse_args(["--device", "cpu", "--precision", "bf16"])
    assert get_renderer(args, {"near": 2.0, "far": 6.0}, "cpu").cfg.precision == "bf16"
    assert get_renderer(config_parser().parse_args([]), {}, "cpu").cfg.precision == "fp32"
