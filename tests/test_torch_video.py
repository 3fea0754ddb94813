"""The port's render-path video on the CPU: its own GIF89a writer
(data/images.gif_encode) decoded by imageio, ``render_only`` writing
video.gif, and the trainer's i_video hook firing at the steps where the JAX
package's fires."""

import io
import os

import imageio.v2 as imageio
import numpy as np
import pytest

import chip_smoke
from nerf_shared_tpu.apps.train import run as jax_run
from nerf_shared_tpu.config import config_parser as jax_parser
from nerf_shared_tpu_torch.apps import train as tapp
from nerf_shared_tpu_torch.config import config_parser
from nerf_shared_tpu_torch.data.images import (
    GIF_MAX_ERROR,
    GIF_PALETTE,
    gif_encode,
    gif_palette_indices,
    imwrite_u8,
)
from nerf_shared_tpu_torch.utils.metrics import to8b


def _frames(n, h, w, seed=0):
    return (np.random.default_rng(seed).random((n, h, w, 3)) * 256).astype(np.uint8)


def _decode(data):
    frames = np.stack(imageio.mimread(io.BytesIO(data), format="GIF"))
    return frames[..., :3]


@pytest.mark.parametrize("n,h,w", [(1, 1, 1), (5, 37, 53), (2, 64, 80), (3, 7, 300)])
def test_gif_decodes_to_the_quantised_frames(n, h, w):
    """imageio (PIL) decodes the writer's GIF to GIF_PALETTE[indices] bit
    for bit: the frame count and size, within GIF_MAX_ERROR of the input a
    channel, and 3 cs (30 ms) a frame at 30 fps. 64 x 80 and 7 x 300 put
    many clear codes and sub-blocks in a frame."""
    frames = _frames(n, h, w, seed=n * h)
    data = gif_encode(frames, fps=30)
    got = _decode(data)
    assert got.shape == (n, h, w, 3)
    np.testing.assert_array_equal(got, GIF_PALETTE[gif_palette_indices(frames)])
    err = np.abs(got.astype(np.int32) - frames).max(axis=(0, 1, 2))
    assert (err <= np.array(GIF_MAX_ERROR)).all(), err
    assert imageio.get_reader(io.BytesIO(data), format="GIF").get_meta_data()[
        "duration"] == 30


def test_gif_palette_error_bound_is_tight():
    """Every 8-bit value of a channel lands on its nearest level, at most
    GIF_MAX_ERROR away, and the bound is reached; the palette has 252
    distinct colours."""
    v = np.arange(256, dtype=np.uint8)
    for c in range(3):
        px = np.zeros((256, 3), np.uint8)
        px[:, c] = v
        q = GIF_PALETTE[gif_palette_indices(px)][:, c].astype(np.int32)
        assert np.abs(q - v).max() == GIF_MAX_ERROR[c]
        levels = np.unique(GIF_PALETTE[:252, c]).astype(np.int32)
        assert (np.abs(q - v) == np.abs(levels[None] - v[:, None]).min(1)).all()
    assert len({tuple(p) for p in GIF_PALETTE[:252]}) == 252


@pytest.mark.parametrize("fps,delay", [(30, 3), (10, 10), (24, 4)])
def test_gif_loops_at_its_frame_rate_and_walks_to_its_frame_count(fps, delay):
    """The NETSCAPE block loops forever and every frame shows round(100 /
    fps) cs (imageio's metadata); chip_smoke.py's block walk, which counts
    the card's video frames where no imaging package is installed, counts
    the frames imageio decodes, and refuses what is not a GIF89a stream."""
    frames = _frames(4, 9, 11)
    data = gif_encode(frames, fps=fps)
    reader = imageio.get_reader(io.BytesIO(data), format="GIF")
    meta = reader.get_meta_data()
    assert (meta["loop"], meta["duration"]) == (0, 10 * delay)
    assert reader.get_length() == 4
    assert chip_smoke.gif_image_count(data) == len(
        imageio.mimread(io.BytesIO(data), format="GIF")) == 4
    with pytest.raises(AssertionError, match="not a GIF89a"):
        chip_smoke.gif_image_count(b"\x89PNG" + data[4:])


def test_gif_encode_rejects_what_it_cannot_write():
    with pytest.raises(ValueError):
        gif_encode(np.zeros((2, 4, 4, 3), np.float32))
    with pytest.raises(ValueError):
        gif_encode(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError):
        gif_encode(np.zeros((1, 4, 4, 4), np.uint8))


# --- render_only and the i_video hook on a tiny LLFF scene ------------------


def _write_llff_scene(root, n=6, size=16):
    """A forward-facing LLFF-format scene: poses_bounds.npy (disk
    convention [down, right, back | hwf], per-view near / far) and PNGs."""
    rng = np.random.default_rng(1)
    os.makedirs(os.path.join(root, "images"))
    rows = []
    for i in range(n):
        imwrite_u8(os.path.join(root, "images", f"img_{i:02d}.png"),
                   (rng.random((size, size, 3)) * 255).astype(np.uint8))
        m = np.eye(4)[:3]
        m[0, 3], m[2, 3] = 0.1 * i, 0.05 * i
        hwf = np.array([[size], [size], [size * 1.2]])
        rows.append(np.concatenate([np.concatenate([m, hwf], 1).ravel(), [1.5, 7.0]]))
    np.save(os.path.join(root, "poses_bounds.npy"), np.stack(rows))


def _llff_config(root, **kw):
    cfg = dict(basedir=os.path.join(root, "logs"), datadir=os.path.join(root, "scene"),
               dataset_type="llff", training=True, factor=1, llffhold=3,
               use_viewdirs=True, N_samples=8, N_importance=8, N_rand=64, netdepth=2,
               netwidth=32, netdepth_fine=2, netwidth_fine=32, multires=4,
               multires_views=2, raw_noise_std=1.0, N_iters=6, i_print=2,
               i_weights=0, i_testset=0, i_img=0, i_video=3)
    cfg.update(kw)
    path = os.path.join(root, "llff.txt")
    with open(path, "w") as f:
        f.write("".join(f"{k} = {v}\n" for k, v in cfg.items()))
    return path


@pytest.fixture(scope="module")
def llff_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("video"))
    _write_llff_scene(os.path.join(root, "scene"))
    return root


def _video_steps(expdir):
    return sorted(int(d.split("_")[1]) for d in os.listdir(expdir) if d.startswith("video_"))


@pytest.mark.parametrize("i_print,jax_steps", [(3, [3, 6]), (2, [6])])
def test_i_video_hook_fires_at_the_jax_steps(llff_root, i_print, jax_steps):
    """Six steps with i_video 3: both write video_<step>/ with a GIF of the
    120-pose spiral. The JAX package checks its hook condition (last %
    i_video == 0 and last > 0) at the end of each superstep of gcd(i_print,
    i_weights, i_testset, i_img) steps; the port checks it every step. With
    i_print 3 the supersteps end on every multiple of 3 and both write
    videos at steps 3 and 6; with i_print 2 the JAX package reaches only
    step 6 and the port writes at 3 and 6 (ROADMAP C, deliberate
    differences)."""
    cfg = _llff_config(llff_root, i_print=i_print)
    jexp, texp = f"jax_p{i_print}", f"port_p{i_print}"
    jax_run(jax_parser().parse_args(["--config", cfg, "--expname", jexp]))
    tapp.main(["--config", cfg, "--expname", texp, "--device", "cpu"])
    logs = os.path.join(llff_root, "logs")
    assert _video_steps(os.path.join(logs, jexp)) == jax_steps
    assert _video_steps(os.path.join(logs, texp)) == [3, 6]
    for step in (3, 6):
        vdir = os.path.join(logs, texp, f"video_{step:06d}")
        pngs = sorted(f for f in os.listdir(vdir) if f.endswith(".png"))
        with open(os.path.join(vdir, "video.gif"), "rb") as f:
            data = f.read()
        assert len(pngs) == 120 and chip_smoke.gif_image_count(data) == 120
        assert imageio.get_reader(io.BytesIO(data), format="GIF").get_meta_data()[
            "duration"] == 30


def test_render_only_writes_the_frames_as_video_gif(llff_root):
    """render_only (the spiral path) writes video.gif beside its PNGs; it
    decodes to the float renders' 8-bit frames through the palette, within
    GIF_MAX_ERROR of them."""
    cfg = _llff_config(llff_root, N_iters=2, i_video=0)
    argv = ["--config", cfg, "--expname", "render", "--device", "cpu"]
    tapp.main(argv)
    outdir, rgbs = tapp.render_only(config_parser().parse_args(
        argv + ["--render_only"]), return_rgbs=True)
    assert rgbs.shape == (120, 16, 16, 3)
    with open(os.path.join(outdir, "video.gif"), "rb") as f:
        got = _decode(f.read())
    want = to8b(rgbs)
    np.testing.assert_array_equal(got, GIF_PALETTE[gif_palette_indices(want)])
    assert (np.abs(got.astype(np.int32) - want).max(axis=(0, 1, 2))
            <= np.array(GIF_MAX_ERROR)).all()
