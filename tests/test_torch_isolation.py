"""The port stands alone: every module of nerf_shared_tpu_torch imports
with JAX made unimportable, and no source of the port (nor chip_smoke.py)
imports jax or the JAX package."""

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
              "models.triplane", "benchmarks.scatter_probe"):
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
