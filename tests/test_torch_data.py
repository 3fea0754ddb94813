"""The port's flag parser, PNG codec and blender loader against the JAX
package (CPU)."""

import glob
import os
import struct
import subprocess
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest

from nerf_shared_tpu.config import config_parser as jax_parser
from nerf_shared_tpu.data import blender as jblender
from nerf_shared_tpu.data import datasets as jdatasets
from nerf_shared_tpu.data import images as jimages
from nerf_shared_tpu_torch.config import config_parser as torch_parser
from nerf_shared_tpu_torch.data import blender as tblender
from nerf_shared_tpu_torch.data import datasets as tdatasets
from nerf_shared_tpu_torch.data.images import png_decode, png_encode, resize_area
from tests.test_e2e import _write_scene

CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..",
                                        "configs", "*.txt")))


def test_there_are_24_configs():
    assert len(CONFIGS) == 24


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_parses_like_jax(path):
    """Every shared flag gets the JAX parser's value; --device replaces
    --jax_backend and defaults to cuda."""
    t = vars(torch_parser().parse_args(["--config", path]))
    j = vars(jax_parser().parse_args(["--config", path]))
    assert t.pop("device") == "cuda"
    j.pop("jax_backend")
    assert t == j


def _png_with_filters(img: np.ndarray) -> bytes:
    """Encode ``img`` [H, W, C] uint8 cycling rows through filter types
    0..4 (None, Sub, Up, Average, Paeth), as an encoder with adaptive
    filtering would."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int32)
    out = []
    for y in range(h):
        ft = y % 5
        cur = x[y]
        prev = x[y - 1] if y > 0 else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prev
        elif ft == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        out.append(bytes([ft]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    def chunk(t, b):
        return (struct.pack(">I", len(b)) + t + b
                + struct.pack(">I", zlib.crc32(t + b) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_reads_all_five_filters(channels):
    img = np.random.default_rng(channels).integers(
        0, 256, (11, 7, channels), dtype=np.uint8)
    got = png_decode(_png_with_filters(img))
    want = img[..., 0] if channels == 1 else img
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(9, 13), (9, 13, 3), (9, 13, 4)])
def test_png_round_trips_with_imageio(tmp_path, shape):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    ours = tmp_path / "ours.png"
    ours.write_bytes(png_encode(img))
    np.testing.assert_array_equal(imageio.imread(ours), img)
    theirs = tmp_path / "theirs.png"
    imageio.imwrite(theirs, img)
    np.testing.assert_array_equal(png_decode(theirs.read_bytes()), img)


def test_png_refuses_what_it_cannot_read():
    with pytest.raises(ValueError):
        png_decode(b"GIF89a")
    with pytest.raises(TypeError):
        png_encode(np.zeros((2, 2), np.float32))


def _hard_scene_frame(size):
    from benchmarks.hard_scene import render_gt_rgba

    c2w = np.eye(4)[:3].copy()
    c2w[2, 3] = 4.0
    return render_gt_rgba(c2w, size, size, 1.1 * size)


@pytest.fixture(scope="module")
def native_resizer(tmp_path_factory):
    """The JAX package's native image library, built by this module alone.

    The library is not part of a checkout, and the JAX package's loader
    builds it in place on first use: test processes that start together
    each run that build, and one may load another's half-written file and
    keep the failure for its lifetime. So the library is built here with
    the Makefile's own rule into a directory of this module's, appears
    under its final name only when whole (``os.replace``), and the loader
    is pointed at it until the module ends."""
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
        yield jimages._native


@pytest.mark.parametrize("shape,out", [((801, 801, 4), (400, 400)),
                                       ((803, 600, 3), (401, 300)),
                                       ((375, 500, 3), (187, 250)),
                                       ((800, 800, 4), (400, 400)),
                                       ("hard_scene", (200, 200))])
def test_resize_area_matches_jax_at_any_factor(native_resizer, shape, out):
    """The exact area average of the JAX package's native resizer, within
    1e-6, at odd and integer factors (half_res on an odd frame)."""
    assert native_resizer.available()
    if shape == "hard_scene":
        img = _hard_scene_frame(401)
    else:
        img = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    assert jimages._native is not None and jimages._native.available()
    got = resize_area(img, *out)
    want = jimages.resize_area(img, *out)
    assert got.dtype == np.float32 and got.shape == want.shape == out + img.shape[2:]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene"))
    _write_scene(root, size=16, n_train=3, n_val=2, n_test=2)
    return root


@pytest.mark.parametrize("half_res,testskip", [(False, 1), (False, 2),
                                               (True, 1)])
def test_blender_loader_matches_jax(scene, half_res, testskip):
    got = tblender.load_blender_data(scene, half_res, testskip)
    want = jblender.load_blender_data(scene, half_res, testskip)
    imgs_t, imgs_j = got[0], want[0]
    if half_res:
        # the JAX loader's 2x2 area average may come from cv2 or its C++
        # resizer instead of the numpy box filter: equal up to fp32 rounding
        np.testing.assert_allclose(imgs_t, imgs_j, atol=1e-6, rtol=0)
    else:
        np.testing.assert_array_equal(imgs_t, imgs_j)
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]
    for g, w in zip(got[4], want[4]):
        np.testing.assert_array_equal(g, w)
    assert got[5:] == want[5:]


@pytest.mark.parametrize("white_bkgd,render_test", [(True, True),
                                                    (False, False)])
def test_load_datasets_matches_jax(scene, white_bkgd, render_test):
    argv = ["--datadir", scene, "--dataset_type", "blender", "--testskip", "1"]
    argv += ["--white_bkgd"] * white_bkgd + ["--render_test"] * render_test
    got = tdatasets.load_datasets(torch_parser().parse_args(argv))
    want = jdatasets.load_datasets(jax_parser().parse_args(argv))
    for f in ("images", "poses", "render_poses", "i_train", "i_val", "i_test",
              "K"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    assert (got.hwf, got.near, got.far) == (want.hwf, want.near, want.far)


def test_unported_dataset_types_raise():
    """Every dataset type of the JAX package is ported (llff, LINEMOD and
    deepvoxels: tests/test_torch_llff.py); a type neither package reads
    raises ValueError in both."""
    args = torch_parser().parse_args(["--dataset_type", "colmap"])
    with pytest.raises(ValueError, match="Unknown dataset type 'colmap'"):
        tdatasets.load_datasets(args)
    with pytest.raises(ValueError, match="Unknown dataset type 'colmap'"):
        jdatasets.load_datasets(jax_parser().parse_args(["--dataset_type", "colmap"]))
