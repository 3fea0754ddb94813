"""The port's loss-guided pixel sampling (train/loss_sampling.py) on the
CPU, against the JAX package's, with JAX's draws pinned through ``draws``:
the tile uniforms and in-tile jitter of ``draw_weighted_pixels`` and the
image index and permutation keys of the single-image draw come from the
JAX keys, split as the JAX functions split them. Pixel draws are held
exactly, rays and targets to 1e-6, the map's update to 1e-6. Also the
precrop gating, the batching refusal and the trainer's flag guards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_shared_tpu.train import loss_sampling as JL
from nerf_shared_tpu.train import pipeline as jpipe
from nerf_shared_tpu_torch.apps import train as tapp
from nerf_shared_tpu_torch.config import config_parser
from nerf_shared_tpu_torch.models import nerf as tnerf
from nerf_shared_tpu_torch.render.renderer import RenderConfig
from nerf_shared_tpu_torch.train import loss_sampling as TL
from nerf_shared_tpu_torch.train import pipeline as tpipe
from nerf_shared_tpu_torch.train.step import make_train_step
from tests.test_torch_train import _key_words, _scene


def _tail_draws(key, n, tile):
    """draw_weighted_pixels' draws from its key, as it splits it."""
    kt, ky, kx = jax.random.split(key, 3)
    return {"tile_u": np.array(jax.random.uniform(kt, (n,))),
            "jitter_y": np.array(jax.random.randint(ky, (n,), 0, tile)),
            "jitter_x": np.array(jax.random.randint(kx, (n,), 0, tile))}


def weighted_draws(key, n_train, N, tile):
    """The draws of JAX's sample_ray_batch_weighted(key, ...) as the port's
    ``draws``: image index, the full-image and precrop permutation keys,
    and the weighted tail's."""
    k_img, k_uni, k_pre, k_wgt = jax.random.split(key, 4)
    return {"img_idx": int(jax.random.randint(k_img, (), 0, n_train)),
            "key_y": _key_words(k_uni), "key_x": _key_words(k_pre),
            **_tail_draws(k_wgt, N, tile)}


def _lmap(n, H, W, tile, seed):
    rng = np.random.default_rng(seed)
    Ht, Wt = TL.grid_shape(H, W, tile)
    m = rng.random((n, Ht, Wt)).astype(np.float32) ** 4   # a peaked map
    return m


@pytest.mark.parametrize("H,W,tile", [(16, 16, 8), (13, 21, 4), (400, 400, 8), (7, 5, 8)])
def test_grid_shape_and_init_match_jax(H, W, tile):
    assert TL.grid_shape(H, W, tile) == JL.grid_shape(H, W, tile)
    got = TL.init_loss_map(3, H, W, tile)
    want = np.asarray(JL.init_loss_map(3, H, W, tile))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("H,W,tile,n,seed", [(16, 24, 4, 64, 0), (13, 21, 4, 200, 1),
                                             (40, 40, 8, 512, 2), (9, 9, 8, 33, 3)])
def test_draw_weighted_pixels_matches_jax(H, W, tile, n, seed):
    """The same tile weights and draws: the same pixels, exactly; every
    pixel inside the image and inside its drawn tile."""
    row = _lmap(1, H, W, tile, seed)[0]
    key = jax.random.PRNGKey(seed)
    jy, jx = JL.draw_weighted_pixels(key, jnp.asarray(row), n, H, W, tile, 1e-3)
    ty, tx = TL.draw_weighted_pixels(torch.from_numpy(row), n, H, W, tile, 1e-3,
                                     draws=_tail_draws(key, n, tile))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert int(ty.min()) >= 0 and int(ty.max()) < H and int(tx.max()) < W


def test_draw_weighted_pixels_follows_the_map():
    """Unpinned, on a map with one hot tile: most draws land in it (the
    rest share the floor), all on the map's device, int64."""
    row = torch.zeros(4, 4)
    row[2, 1] = 1.0
    y, x = TL.draw_weighted_pixels(row, 4000, 32, 32, 8, 1e-3,
                                   generator=torch.Generator().manual_seed(0))
    assert y.dtype == x.dtype == torch.int64
    hot = ((y // 8 == 2) & (x // 8 == 1)).float().mean()
    assert float(hot) > 0.95


@pytest.mark.parametrize("decay", [0.9, 0.5])
@pytest.mark.parametrize("seed", [0, 1])
def test_update_loss_map_matches_jax(decay, seed):
    """Observed tiles blend their mean error in, unobserved tiles and other
    images keep theirs: to 1e-6."""
    H, W, tile, N = 24, 20, 4, 48
    rng = np.random.default_rng(seed)
    lmap = _lmap(3, H, W, tile, seed)
    y = rng.integers(0, H, N).astype(np.int64)
    x = rng.integers(0, W // 2, N).astype(np.int64)   # half the tiles unseen
    err = rng.random(N).astype(np.float32)
    want = JL.update_loss_map(jnp.asarray(lmap), 1, jnp.asarray(y), jnp.asarray(x),
                              jnp.asarray(err), tile, decay)
    got = TL.update_loss_map(torch.from_numpy(lmap.copy()), 1, torch.from_numpy(y),
                             torch.from_numpy(x), torch.from_numpy(err), tile, decay)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.numpy()[[0, 2]], lmap[[0, 2]])
    assert (got.numpy()[1] != lmap[1]).any()


@pytest.mark.parametrize("step,frac,N", [(0, 0.5, 32), (5, 0.5, 32), (5, 0.25, 33),
                                         (5, 0.0, 32), (5, 1.0, 16), (5, 0.5, 400)])
def test_sample_ray_batch_weighted_matches_jax(step, frac, N):
    """The uniform head, the weighted tail and the precrop gating (step 0
    is inside the 2-step window: every ray uniform): pixels exactly, rays
    and targets to 1e-6. N 400 > H W wraps the permutation."""
    images, poses, K = _scene(n=3, H=12, W=10, seed=N % 7)
    lmap = _lmap(3, 12, 10, 4, step)
    ls_kw = dict(tile=4, frac=frac, decay=0.9)
    kw = dict(single_image=True, precrop_iters=2, precrop_frac=0.5)
    jspec = jpipe.PixelSamplerSpec.from_K(12, 10, K, N, **kw)
    tspec = tpipe.PixelSamplerSpec.from_K(12, 10, K, N, **kw)
    key = jax.random.PRNGKey(31 + step)
    want = JL.sample_ray_batch_weighted(key, jnp.asarray(images), jnp.asarray(poses),
                                        jnp.asarray(step), jspec, jnp.asarray(lmap),
                                        JL.LossSamplingSpec(**ls_kw))
    got = TL.sample_ray_batch_weighted(None, None, torch.from_numpy(images),
                                       torch.from_numpy(poses), step, tspec,
                                       torch.from_numpy(lmap), TL.LossSamplingSpec(**ls_kw),
                                       draws=weighted_draws(key, 3, N, 4))
    for name, g, w in zip(("rays_o", "rays_d", "target", "img_idx", "y", "x"), got, want):
        w = np.asarray(w)
        if name in ("img_idx", "y", "x"):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6, err_msg=name)
    if step < 2:
        h = (got[4] >= 3) & (got[4] < 9) & (got[5] >= 3) & (got[5] < 8)
        assert bool(h.all())   # precrop: every ray in the centre window


def test_the_weighted_tail_is_drawn_on_the_maps_device_from_its_generator():
    """Unpinned: the same device generator seed gives the same tail, the
    head is the uniform sampler's draw."""
    images, poses, K = _scene(n=2, H=16, W=16, seed=0)
    spec = tpipe.PixelSamplerSpec.from_K(16, 16, K, 64, single_image=True)
    ls = TL.LossSamplingSpec(tile=4, frac=0.5)
    lmap = torch.from_numpy(_lmap(2, 16, 16, 4, 0))

    def draw(seed):
        return TL.sample_ray_batch_weighted(
            torch.Generator().manual_seed(1), torch.Generator().manual_seed(seed),
            torch.from_numpy(images), torch.from_numpy(poses), 10, spec, lmap, ls)

    a, b, c = draw(5), draw(5), draw(6)
    assert torch.equal(a[4], b[4]) and torch.equal(a[5], b[5])
    assert not torch.equal(a[4][32:], c[4][32:]) and torch.equal(a[4][:32], c[4][:32])
    _, y, x = tpipe.sample_pixels(torch.Generator().manual_seed(1), 2, 10, spec)
    assert torch.equal(a[4][:32], y[:32]) and torch.equal(a[5][:32], x[:32])


def test_batching_sampler_is_refused():
    """--loss_sampling targets the single-image sampler, in both packages."""
    images, poses, K = _scene(n=2, H=8, W=8, seed=0)
    tspec = tpipe.PixelSamplerSpec.from_K(8, 8, K, 16, single_image=False)
    jspec = jpipe.PixelSamplerSpec.from_K(8, 8, K, 16, single_image=False)
    ls = TL.LossSamplingSpec()
    with pytest.raises(ValueError, match="single-image"):
        TL.sample_ray_batch_weighted(None, None, torch.from_numpy(images),
                                     torch.from_numpy(poses), 0, tspec,
                                     TL.init_loss_map(2, 8, 8, 8), ls)
    cfg = tnerf.NeRFConfig(D=2, W=16, skips=(4,), multires=4, multires_views=2)
    with pytest.raises(ValueError, match="single-image"):
        make_train_step(RenderConfig(N_samples=4, N_importance=4), cfg, cfg, tspec,
                        loss_sampling=ls)
    from nerf_shared_tpu.models.nerf import NeRFConfig as JCfg
    from nerf_shared_tpu.render.renderer import RenderConfig as JRC
    from nerf_shared_tpu.train.step import make_fused_train_step

    jcfg = JCfg(D=2, W=16, skips=(4,), multires=4, multires_views=2)
    with pytest.raises(ValueError, match="single-image"):
        make_fused_train_step(JRC(N_samples=4, N_importance=4), jcfg, jcfg, jspec,
                              loss_sampling=JL.LossSamplingSpec())


@pytest.mark.parametrize("argv,match", [
    (["--loss_sampling", "True"], "--no_batching"),
    (["--loss_sampling", "True", "--no_batching", "--train_occ", "True"],
     "the occ trainer has its own candidate sampler"),
    (["--ema_decay", "0.99", "--train_occ", "True"],
     "the occ trainer does not maintain the EMA shadow"),
    (["--proposal", "True", "--train_occ", "True"], "alternative accelerants"),
])
def test_trainer_guards_match_jax(argv, match):
    """The JAX trainer's exits, with its messages: --loss_sampling without
    --no_batching, and --loss_sampling, --ema_decay or --proposal with
    --train_occ (ported since the occupancy-gated trainer's slice)."""
    args = config_parser().parse_args(["--device", "cpu"] + argv)
    with pytest.raises(SystemExit, match=match):
        tapp.train(args)


def test_loss_sampling_spec_from_flags():
    args = config_parser().parse_args(["--loss_sampling", "True", "--loss_sampling_tile",
                                       "4", "--loss_sampling_frac", "0.25",
                                       "--loss_sampling_decay", "0.8"])
    assert tapp.loss_sampling_spec(args) == TL.LossSamplingSpec(tile=4, frac=0.25,
                                                                decay=0.8)
    assert tapp.loss_sampling_spec(config_parser().parse_args([])) is None
