"""The port's JPEG decoder (data/jpeg.py) on the CPU, against the JAX
package's read (imageio -> Pillow -> libjpeg-turbo at its defaults).

Pillow writes every JPEG inside the test; the port's ``imread_float`` must
equal ``nerf_shared_tpu.data.images.imread_float`` bit for bit at qualities
50 / 75 / 95, subsampling 4:4:4 / 4:2:2 / 4:2:0, greyscale, restart markers
(by blocks and by rows), optimised Huffman tables, 16-bit quantisation
tables (SOF1), odd sizes and an EXIF orientation tag (ignored by both).
Progressive, CMYK and RGB JPEGs raise naming the item. The codec is picked
by the file's signature. The LLFF loader, ``minify_images`` and the LINEMOD
loader read JPEG scenes as the JAX package does. The committed fixtures
under tests/data/jpeg/ (for the card's machine, which has no imaging
package) decode to Pillow's arrays in their .npz; regenerate them with
``python -m tests.test_torch_jpeg``.
"""

import hashlib
import io
import json
import os
import shutil

import numpy as np
import pytest

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg")


def _picture(h, w, grey=False, seed=0, noise=10.0):
    """A smooth picture with noise on it (JPEG's usual content)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    img = np.stack([128 + 100 * np.sin(xx / 7.0) * np.cos(yy / 11.0),
                    128 + 90 * np.sin((xx + yy) / 13.0),
                    128 + 80 * np.cos(xx / 5.0 - yy / 9.0)], -1)
    img = np.clip(img + rng.normal(0, noise, img.shape), 0, 255).astype(np.uint8)
    return img[..., 0] if grey else img


def _jpeg_bytes(img, **kw):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


# (name, (h, w), grey, noise, Pillow's save options): the committed
# fixtures. s420_rate is the one chip_smoke.py times: its array would not
# fit the fixtures' 200 KB, so the .npz holds its shape and the SHA-256 of
# its bytes (``<name>.shape``, ``<name>.sha256``)
FIXTURE_CASES = [
    ("s444_q95", (37, 53), False, 10.0, dict(quality=95, subsampling=0)),
    ("s422_q75", (37, 53), False, 10.0, dict(quality=75, subsampling=1)),
    ("s420_q50", (37, 53), False, 10.0, dict(quality=50, subsampling=2)),
    ("grey_q75", (37, 53), True, 10.0, dict(quality=75)),
    ("s420_restart", (48, 64), False, 10.0, dict(quality=75, subsampling=2,
                                                  restart_marker_blocks=3)),
    ("s422_optimized", (40, 56), False, 10.0, dict(quality=85, subsampling=1,
                                                    optimize=True)),
    ("s420_odd", (67, 101), False, 10.0, dict(quality=90, subsampling=2)),
    ("s420_rate", (480, 640), False, 4.0, dict(quality=90, subsampling=2)),
]
DIGEST_ONLY = ("s420_rate",)


def write_fixtures(outdir=FIXTURES):
    """Write the fixtures' JPEGs and Pillow's decoded arrays (fixtures.npz)."""
    from PIL import Image

    os.makedirs(outdir, exist_ok=True)
    arrays = {}
    for name, (h, w), grey, noise, kw in FIXTURE_CASES:
        data = _jpeg_bytes(_picture(h, w, grey, seed=len(name), noise=noise), **kw)
        with open(os.path.join(outdir, name + ".jpg"), "wb") as f:
            f.write(data)
        arr = np.asarray(Image.open(io.BytesIO(data)))
        if name in DIGEST_ONLY:
            arrays[name + ".shape"] = np.asarray(arr.shape)
            arrays[name + ".sha256"] = np.frombuffer(
                hashlib.sha256(np.ascontiguousarray(arr).tobytes()).digest(), np.uint8)
        else:
            arrays[name] = arr
    np.savez_compressed(os.path.join(outdir, "fixtures.npz"), **arrays)


def fixture_matches(name: str, got: np.ndarray, z) -> bool:
    """Whether ``got`` is Pillow's decode of fixture ``name`` (``z`` the
    loaded fixtures.npz)."""
    if name in DIGEST_ONLY:
        return (tuple(got.shape) == tuple(z[name + ".shape"]) and
                hashlib.sha256(np.ascontiguousarray(got).tobytes()).digest()
                == z[name + ".sha256"].tobytes())
    return got.shape == z[name].shape and bool(np.array_equal(got, z[name]))


def _both(path):
    from nerf_shared_tpu.data import images as jimages
    from nerf_shared_tpu_torch.data.images import imread_float

    return imread_float(path), jimages.imread_float(path)


def _assert_reads_as_jax(tmp_path, data, name="x.jpg"):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    got, want = _both(path)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_colour_jpeg_reads_as_jax(tmp_path, quality, subsampling):
    _assert_reads_as_jax(tmp_path, _jpeg_bytes(_picture(37, 53), quality=quality,
                                               subsampling=subsampling))


@pytest.mark.parametrize("quality", [50, 75, 95])
def test_greyscale_jpeg_reads_as_jax(tmp_path, quality):
    got = _assert_reads_as_jax(tmp_path, _jpeg_bytes(_picture(37, 53, grey=True),
                                                     quality=quality))
    assert got.shape == (37, 53)


@pytest.mark.parametrize("restart", [dict(restart_marker_blocks=1),
                                     dict(restart_marker_blocks=5),
                                     dict(restart_marker_rows=1),
                                     dict(restart_marker_rows=2)],
                         ids=lambda d: "_".join(f"{k}{v}" for k, v in d.items()))
@pytest.mark.parametrize("subsampling", [0, 2])
def test_restart_markers_read_as_jax(tmp_path, restart, subsampling):
    data = _jpeg_bytes(_picture(48, 64), quality=75, subsampling=subsampling, **restart)
    assert b"\xff\xdd" in data and b"\xff\xd0" in data
    _assert_reads_as_jax(tmp_path, data)


@pytest.mark.parametrize("subsampling", [0, 1, 2, None])
def test_optimised_tables_read_as_jax(tmp_path, subsampling):
    grey = subsampling is None
    kw = {} if grey else dict(subsampling=subsampling)
    _assert_reads_as_jax(tmp_path, _jpeg_bytes(_picture(37, 53, grey=grey), quality=80,
                                               optimize=True, **kw))


@pytest.mark.parametrize("size", [(8, 8), (37, 53), (1, 1), (3, 5), (17, 2)])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_odd_sizes_read_as_jax(tmp_path, size, subsampling):
    """Sizes that are not a multiple of the MCU, chroma planes 2 samples
    wide or less (plain replication) included."""
    _assert_reads_as_jax(tmp_path, _jpeg_bytes(_picture(*size), quality=75,
                                               subsampling=subsampling))


def test_sixteen_bit_tables_read_as_jax(tmp_path):
    """Quantisation entries above 255: 16-bit DQT and an SOF1 frame."""
    qt = [list(range(200, 264)), [300 + i for i in range(64)]]
    data = _jpeg_bytes(_picture(37, 53), qtables=qt, subsampling=2)
    assert b"\xff\xc1" in data
    _assert_reads_as_jax(tmp_path, data)


def test_exif_orientation_is_ignored_as_by_jax(tmp_path):
    from PIL import Image

    exif = Image.Exif()
    exif[0x0112] = 6   # "rotate 90 CW to view"
    got = _assert_reads_as_jax(tmp_path, _jpeg_bytes(_picture(37, 53), exif=exif))
    assert got.shape == (37, 53, 3)


@pytest.mark.parametrize("kw,item", [(dict(progressive=True), "progressive"),
                                     (dict(keep_rgb=True), "RGB"),
                                     (dict(mode="CMYK"), "CMYK")])
def test_unsupported_modes_raise_naming_the_item(kw, item):
    from nerf_shared_tpu_torch.data.jpeg import jpeg_decode

    img = _picture(16, 16)
    if kw.pop("mode", None) == "CMYK":
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(img).convert("CMYK").save(buf, "JPEG")
        data = buf.getvalue()
    else:
        data = _jpeg_bytes(img, **kw)
    with pytest.raises(NotImplementedError, match=item):
        jpeg_decode(data)


def test_the_codec_follows_the_signature_not_the_name(tmp_path):
    """A PNG named .jpg and a JPEG named .png both decode, as they do
    through imageio and Pillow."""
    from nerf_shared_tpu_torch.data.images import png_encode

    img = _picture(9, 11)
    got = _assert_reads_as_jax(tmp_path, png_encode(img), name="png.jpg")
    np.testing.assert_array_equal(np.round(got * 255).astype(np.uint8), img)
    _assert_reads_as_jax(tmp_path, _jpeg_bytes(img, quality=90), name="jpeg.png")


def test_committed_fixtures_decode_to_their_arrays():
    from nerf_shared_tpu_torch.data.jpeg import jpeg_decode

    total = os.path.getsize(os.path.join(FIXTURES, "fixtures.npz"))
    with np.load(os.path.join(FIXTURES, "fixtures.npz")) as z:
        for name, *_ in FIXTURE_CASES:
            path = os.path.join(FIXTURES, name + ".jpg")
            with open(path, "rb") as f:
                assert fixture_matches(name, jpeg_decode(f.read()), z), name
            total += os.path.getsize(path)
    assert total < 200_000, total


def test_committed_fixtures_are_pillows_output():
    """Pillow decodes each committed JPEG to the committed array (the .npz
    is Pillow's read, not the port's)."""
    from PIL import Image

    with np.load(os.path.join(FIXTURES, "fixtures.npz")) as z:
        for name, *_ in FIXTURE_CASES:
            img = np.asarray(Image.open(os.path.join(FIXTURES, name + ".jpg")))
            assert fixture_matches(name, img, z), name


# --- the loaders on JPEG scenes ------------------------------------------------------


def _write_jpeg_llff(root, n=6, size=(37, 53), quality=90, subsampling=2):
    os.makedirs(os.path.join(root, "images"))
    for i in range(n):
        with open(os.path.join(root, "images", f"img_{i:02d}.jpg"), "wb") as f:
            f.write(_jpeg_bytes(_picture(*size, seed=i), quality=quality,
                                subsampling=subsampling))
    poses = []
    for i in range(n):
        m = np.eye(4)[:3]
        m[0, 3], m[2, 3] = 0.1 * i, 0.05 * i
        poses.append(np.concatenate([m, [[size[0]], [size[1]], [size[0] * 1.2]]], 1))
    bds = np.stack([np.full(n, 1.5), np.full(n, 7.0)], -1)
    np.save(os.path.join(root, "poses_bounds.npy"),
            np.concatenate([np.stack(poses).reshape(n, -1), bds], axis=1))


@pytest.mark.parametrize("subsampling", [0, 2])
def test_llff_loader_reads_jpeg_images_as_jax(tmp_path, subsampling):
    from nerf_shared_tpu.data.llff import load_llff_data as j_load_llff
    from nerf_shared_tpu_torch.data.llff import load_llff_data

    root = str(tmp_path / "scene")
    _write_jpeg_llff(root, subsampling=subsampling)
    got, want = load_llff_data(root, factor=1), j_load_llff(root, factor=1)
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:4], want[1:4]):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
    assert got[4] == want[4]


@pytest.mark.parametrize("factor", [2, 4])
def test_minify_reads_jpeg_sources_as_jax(tmp_path, factor):
    """images_N/ (PNG) of a JPEG images/ from both packages, each in its own
    copy: the same pixels, except pixels one level apart whose area average
    lies within 1e-5 of a truncation boundary (as tests/test_torch_llff.py
    holds minify); then the loaders agree on what the port wrote."""
    from nerf_shared_tpu.data import images as jimages
    from nerf_shared_tpu_torch.data.images import imread_float, minify_images

    src = str(tmp_path / "src")
    _write_jpeg_llff(src, size=(40, 56))
    mine = shutil.copytree(src, str(tmp_path / "port"))
    theirs = shutil.copytree(src, str(tmp_path / "jax"))
    got_dir, want_dir = minify_images(mine, factor), jimages.minify_images(theirs, factor)
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names and all(n.endswith(".png") for n in names)
    for name in names:
        got = np.round(imread_float(os.path.join(got_dir, name)) * 255).astype(np.int32)
        want = np.round(jimages.imread_float(os.path.join(want_dir, name)) * 255).astype(
            np.int32)
        assert got.shape == want.shape == (round(40 / factor), round(56 / factor), 3)
        assert (np.abs(got - want) <= 1).all()
        src_img = jimages.imread_float(os.path.join(src, "images", name[:-4] + ".jpg"))
        exact = jimages._box_resize(src_img.astype(np.float64), *got.shape[:2]) * 255
        diff = got != want
        assert (np.abs(exact[diff] - np.round(exact[diff])) <= 255 * 1e-5).all()


def test_linemod_loader_reads_jpeg_file_paths_as_jax(tmp_path):
    from nerf_shared_tpu.data.linemod import load_LINEMOD_data as j_load
    from nerf_shared_tpu_torch.data.linemod import load_LINEMOD_data

    root = str(tmp_path / "linemod")
    os.makedirs(os.path.join(root, "imgs"))
    for split in ("train", "val", "test"):
        frames = []
        for i in range(2):
            p = os.path.join(root, "imgs", f"{split}_{i}.jpg")
            with open(p, "wb") as f:
                f.write(_jpeg_bytes(_picture(16, 16, seed=i), quality=85))
            pose = np.eye(4)
            pose[2, 3] = 4.0 + i
            frames.append({"file_path": p, "transform_matrix": pose.tolist(),
                           "intrinsic_matrix": [[10.0, 0, 8], [0, 10.0, 8], [0, 0, 1]]})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"frames": frames, "near": 1.2, "far": 6.7}, f)
    got, want = load_LINEMOD_data(root), j_load(root)
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
    assert list(got[3]) == list(want[3])


if __name__ == "__main__":
    write_fixtures()
