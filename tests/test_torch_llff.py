"""The port's LLFF, DeepVoxels and LINEMOD slice on the CPU, against the
JAX package: the three loaders and ``load_datasets``, ``minify_images``,
one LLFF training step (NDC, batching, sigma noise), one NDC frame and the
evaluation CLI.

The fixtures are small scenes written by the tests (the layouts of the
JAX package's loader tests), in the port's own PNG codec.
"""

import json
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_shared_tpu.apps.eval_cli import extend_parser_for_eval as j_eval_parser
from nerf_shared_tpu.apps.eval_cli import run_eval as j_run_eval
from nerf_shared_tpu.apps.train import render_only as j_render_only
from nerf_shared_tpu.config import config_parser as jax_parser
from nerf_shared_tpu.data import datasets as jdatasets
from nerf_shared_tpu.data import images as jimages
from nerf_shared_tpu.data.deepvoxels import load_dv_data as j_load_dv
from nerf_shared_tpu.data.linemod import load_LINEMOD_data as j_load_linemod
from nerf_shared_tpu.data.llff import load_llff_data as j_load_llff
from nerf_shared_tpu.factory import create_nerf_models as j_create_models
from nerf_shared_tpu.models import nerf as jnerf
from nerf_shared_tpu.render.renderer import RenderConfig as JRenderConfig
from nerf_shared_tpu.render.renderer import render_rays as j_render_rays
from nerf_shared_tpu.train import pipeline as jpipe
from nerf_shared_tpu.train.state import create_train_state as j_create_state
from nerf_shared_tpu.train.step import pack_ray_batch as j_pack
from nerf_shared_tpu.utils.checkpoints import save_tar as j_save_tar
from nerf_shared_tpu.utils.metrics import img2mse as j_img2mse
from nerf_shared_tpu_torch.apps import eval_cli as teval
from nerf_shared_tpu_torch.apps.train import render_only
from nerf_shared_tpu_torch.config import config_parser as torch_parser
from nerf_shared_tpu_torch.data import datasets as tdatasets
from nerf_shared_tpu_torch.data.deepvoxels import load_dv_data
from nerf_shared_tpu_torch.data.images import imread_float, imwrite_u8, minify_images
from nerf_shared_tpu_torch.data.linemod import load_LINEMOD_data
from nerf_shared_tpu_torch.data.llff import load_llff_data
from nerf_shared_tpu_torch.data.poses import view_matrix
from nerf_shared_tpu_torch.models import nerf as tnerf
from nerf_shared_tpu_torch.render.renderer import RenderConfig
from nerf_shared_tpu_torch.train import pipeline as tpipe
from nerf_shared_tpu_torch.train.state import create_train_state
from nerf_shared_tpu_torch.train.step import make_train_step
from nerf_shared_tpu_torch.utils.checkpoints import save_tar


@pytest.fixture(scope="module", autouse=True)
def native_resizer(tmp_path_factory):
    """The JAX package's native image library (its resize_area under
    minify_images, LINEMOD's half_res and the eval CLI's --render_factor),
    built by this module alone, as tests/test_torch_data.py builds it: the
    JAX loader builds it in place on first use, and test processes that
    start together would race on that build. Built with the Makefile's own
    rule into a directory of this module's, moved into place whole, and the
    loader pointed at it until the module ends."""
    native = os.path.join(os.path.dirname(__file__), "..", "native")
    build = tmp_path_factory.mktemp("native")
    subprocess.run(["make", "-B", "-s", "-C", str(build), "-f",
                    os.path.abspath(os.path.join(native, "Makefile")),
                    "VPATH=" + os.path.abspath(native), "libimageops.so"],
                   check=True, capture_output=True, timeout=300)
    so = str(build / "lib" / "libimageops.so")
    os.mkdir(os.path.dirname(so))
    os.replace(str(build / "libimageops.so"), so)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jimages._native, "_SO_PATH", so)
        mp.setattr(jimages._native, "_TRIED", False)
        mp.setattr(jimages._native, "_LIB", None)
        assert jimages._native.available()
        yield jimages._native


# --- fixtures (the JAX package's loader-test layouts) -----------------------


def _write_llff_fixture(root, n=6, size=16, ext=".png"):
    """A forward-facing cluster: poses_bounds.npy ([3,5] pose + hwf, 2
    bounds a view) and images/."""
    rng = np.random.default_rng(1)
    imgdir = os.path.join(root, "images")
    os.makedirs(imgdir)
    for i in range(n):
        img = (rng.random((size, size, 3)) * 255).astype(np.uint8)
        path = os.path.join(imgdir, f"img_{i:02d}{ext}")
        if ext == ".png":
            imwrite_u8(path, img)
        else:
            jimages.imwrite_u8(path, img)
    poses = []
    for i in range(n):
        m = np.eye(4)[:3]
        m[0, 3] = 0.1 * i
        m[2, 3] = 0.05 * i
        hwf = np.array([[size], [size], [size * 1.2]])
        poses.append(np.concatenate([m, hwf], axis=1))
    poses = np.stack(poses)
    bds = np.stack([np.full(n, 1.5), np.full(n, 7.0)], -1)
    np.save(os.path.join(root, "poses_bounds.npy"),
            np.concatenate([poses.reshape(n, -1), bds], axis=1))


def _write_llff_ring_fixture(root, n=8, size=8):
    """Cameras on a ring looking inward (non-degenerate for spherify)."""
    rng = np.random.default_rng(3)
    imgdir = os.path.join(root, "images")
    os.makedirs(imgdir)
    poses = []
    for i in range(n):
        imwrite_u8(os.path.join(imgdir, f"img_{i:02d}.png"),
                   (rng.random((size, size, 3)) * 255).astype(np.uint8))
        th = 2 * np.pi * i / n
        pos = np.array([3 * np.cos(th), 3 * np.sin(th), 0.5])
        m = view_matrix(pos / np.linalg.norm(pos), np.array([0.0, 0.0, 1.0]), pos)
        poses.append(np.concatenate([m, np.array([[size], [size], [size * 1.2]])], 1))
    poses = np.stack(poses)
    bds = np.stack([np.full(n, 1.5), np.full(n, 7.0)], -1)
    np.save(os.path.join(root, "poses_bounds.npy"),
            np.concatenate([poses.reshape(n, -1), bds], axis=1))


def _write_dv_fixture(root, scene="cube", n=3, size=512):
    rng = np.random.default_rng(4)
    for split in ("train", "test", "validation"):
        base = os.path.join(root, split, scene)
        os.makedirs(os.path.join(base, "pose"))
        os.makedirs(os.path.join(base, "rgb"))
        for i in range(n):
            pose = np.eye(4)
            pose[:3, 3] = [0.3 * i, -0.2, 3.0 + 0.1 * i]
            with open(os.path.join(base, "pose", f"{i:03d}.txt"), "w") as f:
                f.write(" ".join(str(x) for x in pose.ravel()))
            img = np.full((size, size, 3), 128, np.uint8)
            img[: size // 4] = rng.integers(0, 256, 3)
            imwrite_u8(os.path.join(base, "rgb", f"{i:03d}.png"), img)
        if split == "train":
            with open(os.path.join(base, "intrinsics.txt"), "w") as f:
                f.write(f"{size * 1.5} {size / 2} {size / 2}\n0 0 0\n0.5\n1.0\n"
                        f"{size} {size}\n")


def _write_linemod_fixture(root, n=2, size=8):
    rng = np.random.default_rng(2)
    os.makedirs(os.path.join(root, "imgs"), exist_ok=True)
    for split in ("train", "val", "test"):
        frames = []
        for i in range(n):
            p = os.path.join(root, "imgs", f"{split}_{i}.png")
            imwrite_u8(p, (rng.random((size, size, 3)) * 255).astype(np.uint8))
            pose = np.eye(4)
            pose[2, 3] = 4.0 + i
            frames.append({"file_path": p, "transform_matrix": pose.tolist(),
                           "intrinsic_matrix": [[10.0, 0, 4], [0, 10.0, 4], [0, 0, 1]]})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"frames": frames, "near": 1.2, "far": 6.7}, f)


def _copy(src, dst):
    shutil.copytree(src, dst)
    return dst


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("llff_scenes"))
    out = {k: os.path.join(root, k) for k in ("llff", "ring", "dv", "linemod", "dv4")}
    _write_llff_fixture(out["llff"])
    _write_llff_ring_fixture(out["ring"])
    _write_dv_fixture(out["dv"], n=2)
    _write_dv_fixture(out["dv4"], n=4, size=512)
    _write_linemod_fixture(out["linemod"])
    return out


# --- loaders ------------------------------------------------------------------


@pytest.mark.parametrize("kind,kw", [
    ("llff", dict(factor=1)),
    ("llff", dict(factor=2)),
    ("llff", dict(factor=1, path_zflat=True)),
    ("ring", dict(factor=1, spherify=True)),
])
def test_llff_loader_matches_jax(scenes, tmp_path, kind, kw):
    """Images bit-equal; poses, bounds and the render path within 1e-6;
    the same holdout view. factor 2 reads the images_2/ cache the JAX
    package wrote (minify_images returns it untouched)."""
    root = _copy(scenes[kind], str(tmp_path / kind))
    want = j_load_llff(root, **kw)
    got = load_llff_data(root, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:4], want[1:4]):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
    assert got[4] == want[4]
    if kw.get("factor") == 2:
        assert got[0].shape == (6, 8, 8, 3) and got[1][0, 2, 4] == pytest.approx(9.6)


@pytest.mark.parametrize("testskip", [1, 2])
def test_deepvoxels_loader_matches_jax(scenes, testskip):
    got = load_dv_data(scene="cube", basedir=scenes["dv4"], testskip=testskip)
    want = j_load_dv(scene="cube", basedir=scenes["dv4"], testskip=testskip)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[2], want[2], atol=1e-6, rtol=0)
    assert list(got[3]) == list(want[3])
    for g, w in zip(got[4], want[4]):
        np.testing.assert_array_equal(g, w)
    assert len(got[4][2]) == 4 // testskip


@pytest.mark.parametrize("half_res,testskip", [(False, 1), (True, 1), (False, 2)])
def test_linemod_loader_matches_jax(scenes, half_res, testskip):
    """Images bit-equal at full resolution; under half_res within 1e-6 (the
    port's exact area average against the JAX package's native resizer,
    as tests/test_torch_data.py holds resize_area)."""
    got = load_LINEMOD_data(scenes["linemod"], half_res=half_res, testskip=testskip)
    want = j_load_linemod(scenes["linemod"], half_res=half_res, testskip=testskip)
    if half_res:
        assert got[0].shape == want[0].shape == (6, 4, 4, 3)
        np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)
    else:
        np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
    assert list(got[3]) == list(want[3])
    np.testing.assert_array_equal(got[4], want[4])
    for g, w in zip(got[5], want[5]):
        np.testing.assert_array_equal(g, w)
    assert got[6:] == want[6:] == (1.0, 7.0)


def _assert_datasets_equal(got, want, image_atol=0.0):
    if image_atol:
        np.testing.assert_allclose(got.images, want.images, atol=image_atol, rtol=0)
    else:
        np.testing.assert_array_equal(got.images, want.images)
    for f in ("poses", "render_poses", "K"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), atol=1e-6, rtol=0,
                                   err_msg=f)
    for f in ("i_train", "i_val", "i_test"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    assert (got.hwf, got.near, got.far) == (want.hwf, want.near, want.far)


@pytest.mark.parametrize("flags", [
    ["--llffhold", "8"], ["--llffhold", "2"], ["--llffhold", "0"],
    ["--llffhold", "8", "--no_ndc"], ["--llffhold", "2", "--render_test"],
    ["--llffhold", "3", "--spherify"],
], ids=lambda f: "_".join(a.strip("-") for a in f))
def test_load_datasets_llff_matches_jax(scenes, tmp_path, flags):
    """llffhold splits (i_val = i_test; llffhold 0 holds out the view
    closest to the mean pose), NDC bounds 0 / 1 or 0.9 bds.min / bds.max
    under --no_ndc, the pinhole K, the render_test pose swap."""
    root = _copy(scenes["ring" if "--spherify" in flags else "llff"],
                 str(tmp_path / "scene"))
    argv = ["--datadir", root, "--dataset_type", "llff", "--factor", "1"] + flags
    got = tdatasets.load_datasets(torch_parser().parse_args(argv))
    want = jdatasets.load_datasets(jax_parser().parse_args(argv))
    _assert_datasets_equal(got, want)
    if "--no_ndc" not in flags:
        assert (got.near, got.far) == (0.0, 1.0)


@pytest.mark.parametrize("kind,flags", [
    ("linemod", ["--dataset_type", "LINEMOD", "--white_bkgd"]),
    ("linemod", ["--dataset_type", "LINEMOD", "--half_res", "--render_test"]),
    ("dv", ["--dataset_type", "deepvoxels", "--shape", "cube", "--testskip", "1"]),
    ("dv", ["--dataset_type", "deepvoxels", "--shape", "cube", "--render_test"]),
])
def test_load_datasets_linemod_and_deepvoxels_match_jax(scenes, kind, flags):
    """LINEMOD keeps its own K (not the pinhole from the focal);
    deepvoxels' bounds are the capture hemisphere's radius -+ 1."""
    argv = ["--datadir", scenes[kind], "--testskip", "1"] + flags
    got = tdatasets.load_datasets(torch_parser().parse_args(argv))
    want = jdatasets.load_datasets(jax_parser().parse_args(argv))
    _assert_datasets_equal(got, want, image_atol=1e-6 if "--half_res" in flags else 0.0)
    if kind == "linemod":
        np.testing.assert_array_equal(got.K, [[10.0, 0, 4], [0, 10.0, 4], [0, 0, 1]])


# --- minify_images --------------------------------------------------------------


@pytest.mark.parametrize("size,factor", [(16, 2), (37, 4), (53, 3)])
def test_minify_matches_jax(tmp_path, size, factor):
    """images_N/ from the port and from the JAX package, each made in its
    own copy of the fixture, decode to the same pixels, except pixels one
    level apart whose area average lies within 1e-5 of a truncation
    boundary k / 255 (the two resizers round that average differently,
    and ``astype(uint8)`` truncates); they are counted."""
    src = str(tmp_path / "src")
    _write_llff_fixture(src, size=size)
    mine, theirs = _copy(src, str(tmp_path / "port")), _copy(src, str(tmp_path / "jax"))
    got_dir, want_dir = minify_images(mine, factor), jimages.minify_images(theirs, factor)
    assert os.path.basename(got_dir) == os.path.basename(want_dir) == f"images_{factor}"
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names and len(names) == 6
    at_boundary = 0
    for name in names:
        got = np.round(imread_float(os.path.join(got_dir, name)) * 255).astype(np.int32)
        want = np.round(jimages.imread_float(os.path.join(want_dir, name)) * 255).astype(
            np.int32)
        out = round(size / factor)
        assert got.shape == want.shape == (out, out, 3)
        diff = got != want
        assert (np.abs(got - want) <= 1).all()
        # the exact area average, in float64, of the source pixels
        exact = _exact_area(imread_float(os.path.join(src, "images", name)), out) * 255
        assert (np.abs(exact[diff] - np.round(exact[diff])) <= 255 * 1e-5).all()
        at_boundary += int(diff.sum())
    print(f"minify x{factor}: {at_boundary} of {6 * out * out * 3} values one level "
          "apart, each at a truncation boundary")


def _exact_area(img, out):
    """Area average of a square float image to out x out, in float64 from
    the definition (covered fraction of each source pixel)."""
    n = img.shape[0]
    w = np.zeros((out, n))
    for o in range(out):
        lo, hi = o * n / out, (o + 1) * n / out
        for i in range(n):
            w[o, i] = max(0.0, min(i + 1, hi) - max(i, lo))
    w /= w.sum(1, keepdims=True)
    return np.einsum("oi,pj,ijc->opc", w, w, img.astype(np.float64))


def test_minify_returns_an_existing_cache_untouched(tmp_path):
    root = str(tmp_path / "scene")
    _write_llff_fixture(root)
    first = minify_images(root, 2)
    stamp = {f: os.path.getmtime(os.path.join(first, f)) for f in os.listdir(first)}
    os.remove(os.path.join(root, "images", "img_00.png"))
    assert minify_images(root, 2) == first
    assert {f: os.path.getmtime(os.path.join(first, f)) for f in os.listdir(first)} == stamp
    assert not os.path.exists(first + ".partial")


@pytest.mark.parametrize("factor", [1, 4])
def test_jpeg_sources_raise(tmp_path, factor):
    """JPEG images/ (imageio's writer) load as the JAX package loads them,
    now that the port decodes JPEG (this test asserted the raise before
    the decoder, data/jpeg.py): at factor 1 bit for bit, at factor 4
    through each package's images_4/ within one level (the minified
    pixels round at truncation boundaries as test_minify_matches_jax
    holds them); poses and bounds within 1e-6."""
    root = str(tmp_path / "scene")
    _write_llff_fixture(root, ext=".jpg")
    theirs = _copy(root, str(tmp_path / "jax"))
    got, want = load_llff_data(root, factor=factor), j_load_llff(theirs, factor=factor)
    if factor == 1:
        np.testing.assert_array_equal(got[0], want[0])
    else:
        assert got[0].shape == want[0].shape == (6, 4, 4, 3)
        np.testing.assert_allclose(got[0], want[0], atol=1 / 255 + 1e-7, rtol=0)
    for g, w in zip(got[1:4], want[1:4]):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
    assert got[4] == want[4]


# --- training and rendering -------------------------------------------------------

KW = dict(D=2, W=32, skips=(4,), use_viewdirs=True, multires=4, multires_views=2,
          output_ch=5)


def test_llff_training_step_matches_jax(scenes, tmp_path):
    """One step of the fern recipe in small (D2/W32, 16 + 16 samples, NDC,
    batching, sigma noise 1.0) on the LLFF fixture as both packages load
    it, from the same weights: JAX's batching sampler on its key, the loss
    with the jitter, u and both noise draws pinned, optax's Adam; the
    port's train_step with the same pixels and draws. Loss within 1e-5
    relative; post-Adam parameters within 1e-6 except entries whose JAX
    gradient is within 100 eps (1e-6) of zero without being zero, which
    may differ by up to 2 lr (tests/test_torch_train.py's step
    tolerances)."""
    root = _copy(scenes["llff"], str(tmp_path / "scene"))
    argv = ["--datadir", root, "--dataset_type", "llff", "--factor", "1",
            "--llffhold", "3"]
    ds = tdatasets.load_datasets(torch_parser().parse_args(argv))
    jds = jdatasets.load_datasets(jax_parser().parse_args(argv))
    images, poses = ds.images[ds.i_train], ds.poses[ds.i_train][:, :3, :4]
    np.testing.assert_array_equal(images, jds.images[jds.i_train])
    H, W, focal = ds.hwf
    N, S = 32, 16
    common = dict(N_samples=S, N_importance=S, use_viewdirs=True, white_bkgd=False,
                  ndc=True, near=0.0, far=1.0, perturb=1.0, raw_noise_std=1.0)
    jr, tr = JRenderConfig(**common), RenderConfig(**common)
    jcfg, tcfg = jnerf.NeRFConfig(**KW), tnerf.NeRFConfig(**KW)
    jstate = j_create_state(jax.random.PRNGKey(2), jcfg, jcfg, lrate=5e-4,
                            lrate_decay=250)
    tstate = create_train_state(tcfg, tcfg, "cpu", lrate=5e-4, lrate_decay=250)
    with torch.no_grad():
        for branch, m in tstate.branches():
            m.load_state_dict(tnerf.params_from_jax(jax.device_get(jstate.params[branch])))

    rng = np.random.default_rng(9)
    ov = {"t_rand": rng.random((N, S)), "u": rng.random((N, S)),
          "noise_coarse": rng.standard_normal((N, S)),
          "noise_fine": rng.standard_normal((N, 2 * S))}
    ov = {k: v.astype(np.float32) for k, v in ov.items()}
    key = jax.random.PRNGKey(7)
    jspec = jpipe.PixelSamplerSpec.from_K(H, W, ds.K, N, single_image=False)
    ro, rd, tgt = jpipe.sample_ray_batch(key, jnp.asarray(images), jnp.asarray(poses),
                                         jnp.asarray(0), jspec)
    jb = j_pack(ro, rd, jr, H, W, focal)
    jov = {k: jnp.asarray(v) for k, v in ov.items()}

    def loss(params):
        ret = j_render_rays(params["coarse"], params["fine"], jb, jax.random.PRNGKey(0),
                            jr, jcfg, jcfg, overrides=jov)
        return j_img2mse(ret["rgb_map"], tgt) + j_img2mse(ret["rgb0"], tgt)

    jl, grads = jax.value_and_grad(loss)(jstate.params)
    jstate = jstate.apply_gradients(grads)

    k_img, k_y, k_x = jax.random.split(key, 3)
    n = images.shape[0]
    draws = {"img_idx": np.array(jax.random.randint(k_img, (N,), 0, n)),
             "y": np.array(jax.random.randint(k_y, (N,), 0, H)),
             "x": np.array(jax.random.randint(k_x, (N,), 0, W))}
    tspec = tpipe.PixelSamplerSpec.from_K(H, W, ds.K, N, single_image=False)
    step = make_train_step(tr, tcfg, tcfg, tspec)
    aux = step(tstate, torch.from_numpy(images), torch.from_numpy(poses),
               torch.Generator().manual_seed(0), draws=draws,
               overrides={k: torch.from_numpy(v) for k, v in ov.items()})
    assert float(aux["loss"]) == pytest.approx(float(jl), rel=1e-5)
    for branch, m in tstate.branches():
        want = tnerf.params_from_jax(jax.device_get(jstate.params[branch]))
        jg = tnerf.params_from_jax(jax.device_get(grads[branch]))
        for k, v in m.state_dict().items():
            fragile = (jg[k].abs() < 1e-6) & (jg[k] != 0)
            d = (v - want[k]).abs()
            assert float(torch.cat([d[~fragile], d.new_zeros(1)]).max()) <= 1e-6, \
                (branch, k)
            assert float(d.max()) <= 2 * 5e-4, (branch, k)
    assert tstate.step == tstate.count == 1


SMALL = dict(netdepth=6, netdepth_fine=6, netwidth=32, netwidth_fine=32,
             N_samples=8, N_importance=16, multires=4, multires_views=2)


def _llff_cfg(root, scene, expname):
    cfg = dict(expname=expname, basedir=os.path.join(root, "logs"), datadir=scene,
               dataset_type="llff", factor=1, llffhold=3, use_viewdirs=True,
               raw_noise_std=1.0, chunk=100, **SMALL)
    path = os.path.join(root, f"{expname}.txt")
    with open(path, "w") as f:
        f.write("".join(f"{k} = {v}\n" for k, v in cfg.items()))
    return path


@pytest.fixture(scope="module")
def llff_ckpts(scenes, tmp_path_factory):
    """Two LLFF runs with a .tar each of seeded init weights: one written
    by the JAX package, one by the port."""
    root = str(tmp_path_factory.mktemp("llff_ckpt"))
    scene = _copy(scenes["llff"], os.path.join(root, "scene"))
    cfgs = {}
    for writer in ("jax", "port"):
        cfgs[writer] = _llff_cfg(root, scene, f"by_{writer}")
        expdir = os.path.join(root, "logs", f"by_{writer}")
        if writer == "jax":
            coarse, fine = j_create_models(jax_parser().parse_args(
                ["--config", cfgs[writer]]), jax.random.PRNGKey(3))
            j_save_tar(os.path.join(expdir, "000011.tar"),
                       {"coarse": jax.device_get(coarse.params),
                        "fine": jax.device_get(fine.params)}, None, 11)
        else:
            g = torch.Generator().manual_seed(4)
            cfg = tnerf.NeRFConfig(D=6, W=32, skips=(4,), use_viewdirs=True, multires=4,
                                   multires_views=2, output_ch=5)
            coarse, fine = tnerf.NeRF(cfg, generator=g), tnerf.NeRF(cfg, generator=g)
            save_tar(os.path.join(expdir, "000011.tar"), coarse.state_dict(),
                     fine.state_dict(), 11)
    return cfgs


def test_ndc_frame_matches_jax(llff_ckpts):
    """The held-out views of the LLFF fixture through NDC rays, rendered by
    the JAX package's render_only and the port's from the JAX-written
    .tar: within 1e-4 (tests/test_torch_slice.py's bound); both write
    video.gif beside the PNGs."""
    argv = ["--config", llff_ckpts["jax"], "--render_only", "--render_test"]
    _, want = j_render_only(jax_parser().parse_args(argv), return_rgbs=True)
    outdir, got = render_only(torch_parser().parse_args(argv + ["--device", "cpu"]),
                              return_rgbs=True)
    assert got.shape == want.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert {"000.png", "001.png", "video.gif"} <= set(os.listdir(outdir))


@pytest.mark.parametrize("writer,flags", [("jax", []), ("port", []),
                                          ("jax", ["--render_factor", "2"])])
def test_eval_cli_matches_jax(llff_ckpts, tmp_path, writer, flags):
    """apps/eval_cli.py against the JAX package's on one .tar (written by
    either package, read by both): the same JSON keys, per-view PSNR within
    1e-3 dB and SSIM within 1e-4; with --render_factor the ground truth is
    area-downsampled to the render's size."""
    argv = ["--config", llff_ckpts[writer]] + flags
    jpath, tpath = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    j_run_eval(j_eval_parser(jax_parser()).parse_args(argv + ["--eval_out", jpath]))
    got = teval.main(argv + ["--eval_out", tpath, "--device", "cpu"])
    with open(jpath) as f:
        want = json.load(f)
    with open(tpath) as f:
        assert json.load(f) == got
    assert set(got) == set(want) and got["n_views"] == want["n_views"] == 2
    assert got["step"] == want["step"] == 11
    for g, w in zip(got["views"], want["views"]):
        assert set(g) == set(w) and g["view"] == w["view"]
        assert abs(g["psnr"] - w["psnr"]) <= 1e-3
        assert abs(g["ssim"] - w["ssim"]) <= 1e-4
    assert abs(got["mean_psnr"] - want["mean_psnr"]) <= 1e-3
