"""Config / flag system of the PyTorch port.

The same flag surface as the reference's configargparse parser (reference
nerf_shared/config_parser.py:2-116) and as ``nerf_shared_tpu/config.py``,
so every ``configs/*.txt`` file parses unchanged: a small ArgumentParser
subclass reads ``--config <file>`` with ``key = value`` lines, and the
command line wins over the file, which wins over the defaults.

One flag differs from the JAX package: ``--device`` (default ``cuda``)
replaces ``--jax_backend``. The entry points refuse to fall back to the CPU
when ``cuda`` is asked for and no card is present.
"""

from __future__ import annotations

import argparse
import shlex


def _str2bool(v: str) -> bool:
    return str(v).strip().lower() in ("true", "1", "yes", "on")


class ConfigArgumentParser(argparse.ArgumentParser):
    """argparse.ArgumentParser that accepts ``--config file`` of k = v lines.

    Drop-in replacement for the subset of configargparse behavior the
    reference relies on (reference config_parser.py:5-7): a config file whose
    lines are ``key = value``; blank lines and ``#`` comments ignored;
    command-line flags override file values.
    """

    def parse_args(self, args=None, namespace=None):  # type: ignore[override]
        ns, _ = super().parse_known_args(args=args, namespace=None)
        cfg_path = getattr(ns, "config", None)
        if cfg_path:
            file_defaults = self._read_config_file(cfg_path)
            self.set_defaults(**file_defaults)
        return super().parse_args(args=args, namespace=namespace)

    def _read_config_file(self, path: str) -> dict:
        actions = {a.dest: a for a in self._actions}
        # also allow lookup by option string without dashes
        by_opt = {}
        for a in self._actions:
            for opt in a.option_strings:
                by_opt[opt.lstrip("-")] = a
        out = {}
        with open(path, "r") as f:
            for raw in f:
                line = raw.split("#", 1)[0].strip()
                if not line or "=" not in line:
                    continue
                key, val = line.split("=", 1)
                key, val = key.strip(), val.strip()
                action = actions.get(key) or by_opt.get(key)
                if action is None:
                    continue  # unknown keys in config files are ignored
                out[action.dest] = self._convert(action, val)
        return out

    @staticmethod
    def _convert(action: argparse.Action, val: str):
        if isinstance(
            action, (argparse._StoreTrueAction, argparse._StoreFalseAction)
        ):
            return _str2bool(val)
        if action.type is bool:
            return _str2bool(val)
        if action.nargs in ("+", "*") or isinstance(action.nargs, int):
            parts = shlex.split(val.replace(",", " "))
            conv = action.type or str
            return [conv(p) for p in parts]
        out = action.type(val) if action.type is not None else val
        # argparse only checks `choices` for values that arrive via the
        # command line; values injected from a config file land through
        # set_defaults and would silently bypass validation (e.g.
        # `ckpt_format = npz` training for hours and saving NOTHING)
        if action.choices is not None and out not in action.choices:
            raise SystemExit(
                f"config file: invalid {action.dest} = {val!r} "
                f"(choose from {', '.join(map(str, action.choices))})")
        return out


def resolve_fused_backward(args, device) -> bool:
    """--fused_backward auto resolution: ON for the MLP family on a CUDA
    device unless the flag says false; the CPU always trains through the
    plain versions."""
    fb = getattr(args, "fused_backward", None)
    return ((fb is None or bool(fb)) and str(device).split(":")[0] == "cuda"
            and getattr(args, "model_type", "nerf") == "nerf")


def resolved_occ_alpha_thresh(args) -> float:
    """--occ_alpha_thresh auto default: 1e-2 for the hashgrid family (its
    softplus density floor keeps empty space at a small positive sigma, so
    1e-3 never prunes), else 1e-3."""
    v = getattr(args, "occ_alpha_thresh", None)
    if v is not None:
        return float(v)
    return 1e-2 if getattr(args, "model_type", "nerf") == "hashgrid" else 1e-3


def resolved_hash_sigma_bias(args) -> float:
    """--hash_sigma_bias auto default: 0.01 under --train_occ (a 0.1
    softplus floor sits above the occupancy binarize threshold, the grid
    never prunes, and the occ trainer silently loses its speedup), else
    the NGP-ish 0.1."""
    v = getattr(args, "hash_sigma_bias", None)
    if v is not None:
        return float(v)
    return 0.01 if getattr(args, "train_occ", False) else 0.1


def recipe_warnings(args, n_train_views=None, render_h=None):
    """Warnings for flag combinations measured (with the JAX package) to
    lose quality or throughput; the same texts as its
    ``config.recipe_warnings``. Returns a list of strings."""
    out = []
    model = getattr(args, "model_type", "nerf")
    train_occ = bool(getattr(args, "train_occ", False))
    if model == "hashgrid":
        max_res = int(getattr(args, "hash_max_res", 2048))
        if train_occ and max_res < 1024:
            out.append(
                f"--train_occ with --hash_max_res {max_res}: the "
                "render-resolution ladder fit helps the HIERARCHICAL "
                "estimator but starves the occ trainer — coarse top "
                "levels keep ambient density high, the grid never prunes, "
                "and quality collapses (measured 15.77 dB @ 200k vs 18.9 "
                "dB @ 20k with max_res 2048 — BASELINE.md r4). Keep the "
                "full NGP ladder (--hash_max_res 2048) for --train_occ.")
        if (not train_occ and render_h and
                max_res > 2 * int(render_h)):
            out.append(
                f"hierarchical/proposal hashgrid at {render_h}p with "
                f"--hash_max_res {max_res}: levels finer than the render "
                "resolution are subpixel AND heavily hash-collided; "
                "capping the ladder near the render resolution "
                f"(--hash_max_res {int(render_h) + (-int(render_h)) % 128}) "
                "measured +0.37 dB at equal wall (BASELINE.md r4 "
                "ladder-fit probe).")
        sb = resolved_hash_sigma_bias(args)
        if train_occ and sb > 2.0 * resolved_occ_alpha_thresh(args):
            out.append(
                f"--train_occ with hash_sigma_bias {sb:g} above ~2x the "
                f"occupancy threshold {resolved_occ_alpha_thresh(args):g}: "
                "empty space starts AT the floor and unlearns it slowly, "
                "so the grid may stay ~100% occupied and the occ trainer "
                "loses its speedup (BASELINE.md r4). Use ~0.01, or raise "
                "--occ_alpha_thresh.")
    if (bool(getattr(args, "loss_sampling", False))
            and int(getattr(args, "N_iters", 0)) > 100_000
            and n_train_views is not None and int(n_train_views) < 20):
        out.append(
            f"--loss_sampling over a {int(getattr(args, 'N_iters', 0)):,}"
            f"-step schedule on a {int(n_train_views)}-view dataset: the "
            "error-EMA map amplifies the few-view overfit drift past "
            "~100k steps (measured: final 21.74 dB vs 23.05 uniform at "
            "200k, while PEAK quality arrives 2.5x sooner — BASELINE.md "
            "r4). Either stop near the peak (~30-50k) or disable "
            "--loss_sampling for long schedules on few-view scenes.")
    return out


def config_parser() -> ConfigArgumentParser:
    """Build the flag set of the reference (config_parser.py:2-116) + TPU flags."""
    parser = ConfigArgumentParser()
    parser.add_argument('--config', type=str, default=None,
                        help='path to a key = value config file')
    parser.add_argument("--expname", type=str,
                        help='name of this experiment/run')
    parser.add_argument("--basedir", type=str, default='./logs/',
                        help='root directory for experiment logs/checkpoints')
    parser.add_argument("--datadir", type=str, default='./data/llff/fern',
                        help='dataset root directory')
    parser.add_argument("--training", action='store_true',
                        help='run the training loop')

    # training options
    parser.add_argument("--netdepth", type=int, default=8,
                        help='depth of the coarse MLP')
    parser.add_argument("--netwidth", type=int, default=256,
                        help='width of the coarse MLP')
    parser.add_argument("--netdepth_fine", type=int, default=8,
                        help='depth of the fine MLP')
    parser.add_argument("--netwidth_fine", type=int, default=256,
                        help='width of the fine MLP')
    parser.add_argument("--N_rand", type=int, default=32 * 32 * 4,
                        help='rays per gradient step (the ray batch size)')
    parser.add_argument("--lrate", type=float, default=5e-4,
                        help='Adam learning rate')
    parser.add_argument("--lrate_decay", type=int, default=250,
                        help='LR decays by 10x over this many thousand steps')
    parser.add_argument("--chunk", type=int, default=1024 * 32,
                        help='number of rays processed in parallel (memory knob; '
                             'results identical)')
    parser.add_argument("--netchunk", type=int, default=1024 * 64,
                        help='number of pts sent through network in parallel '
                             '(memory knob; results identical)')
    parser.add_argument("--no_batching", action='store_true',
                        help='sample each batch from a single random image')
    parser.add_argument("--no_reload", action='store_true',
                        help='start fresh: ignore existing checkpoints')
    parser.add_argument("--ft_path", type=str, default=None,
                        help='explicit checkpoint path overriding the newest-in-expdir rule')

    # rendering options
    parser.add_argument("--N_samples", type=int, default=64,
                        help='stratified (coarse) samples per ray')
    parser.add_argument("--N_importance", type=int, default=0,
                        help='hierarchical (fine) resamples per ray; 0 disables the fine pass')
    parser.add_argument("--perturb", type=float, default=1.,
                        help='stratified-sampling jitter amount (0 = deterministic)')
    parser.add_argument("--use_viewdirs", action='store_true',
                        help='condition color on viewing direction (5D input)')
    parser.add_argument("--i_embed", type=int, default=0,
                        help='0: sinusoidal positional encoding; -1: identity')
    parser.add_argument("--multires", type=int, default=10,
                        help='frequency octaves for the position encoding')
    parser.add_argument("--multires_views", type=int, default=4,
                        help='frequency octaves for the direction encoding')
    parser.add_argument("--raw_noise_std", type=float, default=0.,
                        help='stddev of the sigma-noise training regularizer')

    parser.add_argument("--render_only", action='store_true',
                        help='do not optimize, reload weights and render out '
                             'render_poses path')
    parser.add_argument("--render_test", action='store_true',
                        help='use the test-split poses for rendering instead of the camera path')
    parser.add_argument("--render_factor", type=int, default=0,
                        help='render at 1/N resolution for quick previews')
    parser.add_argument("--render_depth", action='store_true',
                        help='also export inverse-depth maps from '
                             '--render_only (NNN_disp.png + disp.npy)')

    # training options (precrop)
    parser.add_argument("--precrop_iters", type=int, default=0,
                        help='train on the image center crop for this many first steps')
    parser.add_argument("--precrop_frac", type=float, default=.5,
                        help='center-crop fraction during precrop_iters')

    # dataset options
    parser.add_argument("--dataset_type", type=str, default='llff',
                        help='one of: llff, blender, deepvoxels, LINEMOD')
    parser.add_argument("--testskip", type=int, default=8,
                        help='stride applied to val/test frames on load')

    # deepvoxels flags
    parser.add_argument("--shape", type=str, default='greek',
                        help='deepvoxels scene name (armchair/cube/greek/vase)')

    # blender flags
    parser.add_argument("--white_bkgd", action='store_true',
                        help='alpha-composite RGBA data onto a white background')
    parser.add_argument("--half_res", action='store_true',
                        help='halve blender resolution on load (800->400)')

    # llff flags
    parser.add_argument("--factor", type=int, default=8,
                        help='LLFF image downsample factor (cached in images_N/)')
    parser.add_argument("--no_ndc", action='store_true',
                        help='disable the NDC ray warp (use for non-forward-facing scenes)')
    parser.add_argument("--lindisp", action='store_true',
                        help='place coarse samples linearly in disparity instead of depth')
    parser.add_argument("--spherify", action='store_true',
                        help='spherify LLFF poses (360-degree captures)')
    parser.add_argument("--llffhold", type=int, default=8,
                        help='hold out every Nth LLFF image as test')

    # logging/saving options
    parser.add_argument("--i_print", type=int, default=100,
                        help='console/metric logging cadence (iterations)')
    parser.add_argument("--i_img", type=int, default=500,
                        help='validation-image render cadence (iterations)')
    parser.add_argument("--i_weights", type=int, default=10000,
                        help='checkpoint cadence (iterations)')
    parser.add_argument("--i_testset", type=int, default=50000,
                        help='test-set render cadence (iterations)')
    parser.add_argument("--i_video", type=int, default=50000,
                        help='render-path video cadence (iterations)')
    parser.add_argument("--tensorboard", type=_str2bool, default=False,
                        help='log statistics and test images with tensorboard')

    # ---- TPU-native flags (new in this framework) ----
    parser.add_argument("--mesh_shape", type=int, nargs='+', default=None,
                        help='device mesh shape for data parallelism, e.g. '
                             '"--mesh_shape 8". Default: all local devices on '
                             'one "data" axis.')
    parser.add_argument("--precision", type=str, default='fp32',
                        choices=['fp32', 'bf16'],
                        help='compute precision for the MLP matmuls')
    parser.add_argument("--model_type", type=str, default='nerf',
                        choices=['nerf', 'triplane', 'hashgrid'],
                        help="model family: 'nerf' = the reference 8x256 "
                             "MLP + positional encoding; 'triplane' = "
                             'grid-based radiance field (three bilinear '
                             'feature planes + tiny decoder, '
                             'models/triplane.py); "hashgrid" = '
                             'multiresolution hash encoding + tiny decoder '
                             '(instant-NGP family, models/hashgrid.py). '
                             'Grid families reach quality in 10-100x fewer '
                             'steps; their table reads and gradients go '
                             'through the gather kernels P1/P2 (the MLP '
                             'kernels B1-B4 are nerf-family only)')
    parser.add_argument("--triplane_res", type=int, default=256,
                        help='triplane: feature-plane resolution G')
    parser.add_argument("--triplane_feat", type=int, default=16,
                        help='triplane: feature channels per plane (summed '
                             'across the three planes)')
    parser.add_argument("--triplane_hidden", type=int, default=64,
                        help='triplane: rgb decoder width')
    parser.add_argument("--triplane_depth", type=int, default=2,
                        help='triplane: rgb decoder layers')
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device for this run: cuda (default; "
                             "raises when no CUDA device is present) or cpu "
                             "(runs the kernels' plain PyTorch versions)")
    parser.add_argument("--triplane_layout", type=str, default="vertex",
                        choices=["vertex", "cell"],
                        help='triplane plane layout: "vertex" = shared '
                             'corners (4 gathered rows per point-plane); '
                             '"cell" = packed corners [G, G, 4C], one row '
                             'per point-plane — 4x fewer rows on TPU\'s '
                             'issue-rate-bound gather/scatter '
                             '(models/triplane.py docstring)')
    parser.add_argument("--triplane_aabb", type=float, default=0.0,
                        help='grid families (triplane AND hashgrid): scene '
                             'half-extent (cube). 0 = auto from the camera '
                             'frustums at load time')
    parser.add_argument("--hash_levels", type=int, default=16,
                        help='hashgrid: number of resolution levels L')
    parser.add_argument("--hash_log2_size", type=int, default=19,
                        help='hashgrid: log2 of the per-level table size T')
    parser.add_argument("--hash_feat", type=int, default=2,
                        help='hashgrid: feature channels per level F')
    parser.add_argument("--hash_base_res", type=int, default=16,
                        help='hashgrid: coarsest grid resolution')
    parser.add_argument("--hash_max_res", type=int, default=2048,
                        help='hashgrid: finest grid resolution')
    parser.add_argument("--hash_hidden", type=int, default=64,
                        help='hashgrid: decoder width (sigma + rgb nets)')
    parser.add_argument("--hash_sigma_bias", type=float, default=None,
                        help="hashgrid: initial softplus density floor. "
                             "Default: auto — 0.1, but 0.01 under "
                             "--train_occ (measured, BASELINE.md r4: a "
                             "0.1 floor sits above the binarize threshold "
                             "so empty space never unlearns it and the "
                             "occupancy grid stays 100%% occupied — the "
                             "trainer silently loses its entire speedup)")
    parser.add_argument("--hash_depth", type=int, default=3,
                        help='hashgrid: rgb decoder layers (incl. output)')
    parser.add_argument("--hash_layout", type=str, default="vertex",
                        choices=["vertex", "cell", "split"],
                        help='hashgrid table layout: "vertex" = NGP-faithful '
                             'shared corners (8 gathered rows per '
                             'point-level); "cell" = packed corners, one '
                             '[8F]-wide row per point-level — 8x fewer rows '
                             'on TPU\'s issue-rate-bound gather/scatter; '
                             '"split" = cell packing + per-level tables '
                             '(direct levels sized exactly N^3) — the '
                             'TPU-fast layout: XLA scatter-add collapses '
                             'with table row count, so per-level tables '
                             'scatter ~5x faster than one fused [L*T] table '
                             '(models/hashgrid.py docstring). Matched param '
                             'count: drop --hash_log2_size by 3 vs "vertex"')
    parser.add_argument("--triplane_upsample", type=str, default="",
                        help="triplane coarse-to-fine schedule: comma list "
                             "of step:G milestones (e.g. '3000:192,"
                             "8000:256'); planes bilinearly upsample and "
                             "the optimizer restarts at the continued LR "
                             "schedule. Standard trainer only (not "
                             "--train_occ). Start resolution = "
                             "--triplane_res; resume infers the current "
                             "resolution from the checkpoint")
    parser.add_argument("--proposal", type=_str2bool, default=False,
                        help='replace the hierarchical coarse NeRF with a '
                             'small density-only PROPOSAL net (mip-NeRF '
                             '360 style): it only drives sample_pdf, '
                             'trained by the interlevel histogram loss '
                             'instead of a coarse mse — cuts the coarse '
                             'branch from ~25%% of the step\'s MLP FLOPs '
                             'to ~1%%. Requires N_importance > 0; MLP '
                             'family only')
    parser.add_argument("--proposal_depth", type=int, default=2,
                        help='proposal MLP depth (layers)')
    parser.add_argument("--proposal_width", type=int, default=64,
                        help='proposal MLP width')
    parser.add_argument("--proposal_loss_weight", type=float, default=1.0,
                        help='interlevel histogram loss weight (mip-NeRF '
                             '360 uses 1.0)')
    parser.add_argument("--refine_poses", type=_str2bool, default=False,
                        help='BARF-style training-time camera refinement: '
                             'each train image gets a learnable se(3) '
                             'correction (zero-init) applied to its pose, '
                             'trained jointly with the field through the '
                             'ray generation — rescues imperfect '
                             'SfM/COLMAP poses. Twists checkpoint in the '
                             'native .npz (dropped by the torch .tar '
                             'schema)')
    parser.add_argument("--pose_lrate", type=float, default=1e-3,
                        help='learning rate for the pose-twist group '
                             '(same exponential decay schedule)')
    parser.add_argument("--refine_poses_from", type=int, default=500,
                        help='start pose refinement at this step: let the '
                             'field settle first — joint from-scratch '
                             'refinement drifts the whole camera rig '
                             '(measured: photometric loss improves while '
                             'every pose gets worse), refining against a '
                             'settled field recovers injected pose error. '
                             '0 = refine from the first step')
    parser.add_argument("--pose_anchor", type=_str2bool, default=True,
                        help='pin the first train image\'s twist to '
                             'identity (gauge fixing)')
    parser.add_argument("--appearance", type=_str2bool, default=False,
                        help='learn a per-train-image exposure/white-'
                             'balance correction (diagonal affine on the '
                             'rendered color, NeRF-W-style) jointly with '
                             'the field — rescues real captures shot with '
                             'auto-exposure; eval renders the uncorrected '
                             'canonical radiance. Image 0 anchors the '
                             'exposure gauge')
    parser.add_argument("--appearance_lrate", type=float, default=1e-3,
                        help='learning rate for the appearance group '
                             '(own Adam, shared decay schedule)')
    parser.add_argument("--ema_decay", type=float, default=0.0,
                        help='exponential moving average of the field '
                             'params for EVAL renders (0 = off; try '
                             '0.999): test-set/video hooks, render_only, '
                             'and checkpointed eval use the averaged '
                             'weights — a free quality win late in '
                             'training. The shadow rides the native '
                             'checkpoint as an ema/ sidecar; training '
                             'itself always uses the raw params')
    parser.add_argument("--loss_sampling", type=_str2bool, default=False,
                        help='loss-guided pixel importance sampling: keep '
                             'a per-(image, tile) EMA of the photometric '
                             'error on device and draw a fraction of each '
                             'batch proportional to it — rays concentrate '
                             'on unconverged regions (edges, thin '
                             'structures). single-image (no_batching) '
                             'sampling only')
    parser.add_argument("--loss_sampling_frac", type=float, default=0.5,
                        help='fraction of N_rand drawn from the loss map '
                             '(the rest keep the uniform draw)')
    parser.add_argument("--loss_sampling_decay", type=float, default=0.9,
                        help='EMA decay of observed tiles in the loss map')
    parser.add_argument("--loss_sampling_tile", type=int, default=8,
                        help='loss-map tile edge in pixels')
    parser.add_argument("--barf_anneal", type=int, default=0,
                        help='BARF coarse-to-fine annealing (Lin et al. '
                             '2021): positional-encoding frequency bands '
                             'fade in linearly, finishing at this step '
                             '(0 = off). Applied in parameter space (first-'
                             'layer row scaling) so the fused kernel needs '
                             'no change; eval renders anneal consistently. '
                             'MLP family only. Enables joint from-scratch '
                             '--refine_poses (replaces the delayed start)')
    parser.add_argument("--barf_anneal_start", type=int, default=0,
                        help='step at which the annealing ramp begins '
                             '(before it, only the identity channels pass)')
    parser.add_argument("--distortion_loss_weight", type=float, default=0.0,
                        help='mip-NeRF 360 distortion loss weight over the '
                             'final pass\'s compositing weights: compacts '
                             'each ray\'s mass into one cluster (floater / '
                             'background-collapse remedy; the paper uses '
                             '0.01 at unbounded-scene scale). Prefix-sum '
                             'form — no pairwise tensor')
    parser.add_argument("--tv_loss_weight", type=float, default=0.0,
                        help='total-variation smoothness weight over grid-'
                             'family feature planes (TensoRF/DVGO '
                             'practice; suppresses floaters on held-out '
                             'views). No-op for the MLP family')
    parser.add_argument("--grid_lrate", type=float, default=2e-2,
                        help='learning rate for grid parameters (the '
                             'feature planes); the decoder uses --lrate. '
                             'Grids want ~40x the MLP rate (TensoRF/DVGO '
                             'practice)')
    parser.add_argument("--use_pallas", type=_str2bool, default=True,
                        help='use the hand-written CUDA kernels on the '
                             'render path (honoured on --device cuda; on '
                             'the CPU the kernels\' plain versions run). '
                             'Flag name kept from the JAX package')
    parser.add_argument("--fused_composite", type=_str2bool, default=False,
                        help='render MLP + alpha composite as one kernel '
                             'launch (no per-sample raw outputs in device '
                             'memory)')
    parser.add_argument("--jax_seed", type=int, default=0,
                        help='base seed (the port seeds a torch.Generator '
                             'with it to initialise weights)')
    parser.add_argument("--N_iters", type=int, default=200000,
                        help='number of training iterations (reference '
                             'main.py:60 hardcodes 200000)')
    parser.add_argument("--exact_epochs", type=_str2bool, default=False,
                        help='batching mode: walk a true without-replacement '
                             'epoch permutation (stateless Feistel bijection) '
                             'instead of i.i.d. pixel draws — the reference '
                             'epoch-shuffle semantics, device-side')
    parser.add_argument("--acc_loss_weight", type=float, default=0.0,
                        help='density-sparsity (Cauchy) regularizer weight: '
                             'trains empty space toward true transparency, '
                             'enabling --render_gate acceleration')
    parser.add_argument("--render_gate", type=float, default=0.0,
                        help='fast rendering: skip the fine pass for rays '
                             'whose coarse opacity is below this threshold '
                             '(0 = off/exact; 1e-3 is a good value for '
                             'object scenes)')
    parser.add_argument("--occ_grid", type=int, default=0,
                        help='fast rendering: build an occupancy grid of '
                             'this resolution (e.g. 128) from the trained '
                             'density field and evaluate the network only '
                             'at grid-occupied sample points (0 = off)')
    parser.add_argument("--occ_alpha_thresh", type=float, default=None,
                        help='occupancy-grid build threshold: cells whose '
                             'one-cell-crossing alpha stays below this are '
                             'treated as empty. Default: auto — 1e-3, but '
                             '1e-2 for --model_type hashgrid (whose '
                             'softplus density floor keeps empty space at '
                             'a small positive sigma; 1e-3 never prunes '
                             'there — measured, BASELINE.md r4)')
    parser.add_argument("--occ_candidates", type=int, default=128,
                        help='candidate depths per ray triaged through the '
                             'occupancy grid before network evaluation')
    parser.add_argument("--warmup_noise", type=int, default=0,
                        help='sigma-noise warmup: train the first N steps '
                             'with raw_noise_std>=1.0, then the configured '
                             'value. The measured escape from the white-'
                             'background transparency trap (a stream-'
                             'dependent collapse where sigma freezes in '
                             'the relu dead zone and PSNR sticks at ~8 '
                             'dB; the reference recipe is vulnerable to '
                             'it too). The trainer prints a collapse '
                             'warning when it detects the trap.')
    parser.add_argument("--render_guided", type=int, default=0,
                        help='proposal-guided exact-quality rendering: at '
                             'RENDER time the fine pass evaluates only '
                             'this many samples placed by the coarse/'
                             'proposal histogram instead of the dense '
                             'N_samples+N_importance union (e.g. 48 ≈ '
                             '2-3x faster exact-path frames; needs no '
                             'occupancy grid and works on any content '
                             'straight from the checkpoint; multiple of 8 '
                             'keeps the Pallas ray kernel eligible). '
                             '0 = off. Training is unaffected.')
    parser.add_argument("--occ_keep", type=int, default=64,
                        help='network evaluations per ray: the nearest '
                             'occupied candidates kept after grid triage')
    parser.add_argument("--occ_mode", type=str, default='froxel',
                        choices=['froxel', 'grid'],
                        help='occupancy triage for pose renders: froxel = '
                             'per-frame camera-frustum resampling (gather-'
                             'free per-ray path, fastest); grid = per-'
                             'candidate world-grid lookups')
    parser.add_argument("--occ_select", type=str, default='sort',
                        choices=['sort', 'onehot', 'weighted'],
                        help="grid-mode candidate selection: 'sort'/'onehot'"
                             ' keep the K nearest occupied candidates (two '
                             'equivalent TPU formulations); '
                             "'weighted' ranks by estimated compositing "
                             'contribution alpha*T from the grid density — '
                             'better small-K fidelity behind thin near '
                             "clutter. Applies to --occ_mode grid; the "
                             'froxel path weights automatically when the '
                             'grid carries density')
    parser.add_argument("--occ_fine", type=int, default=0,
                        help='hierarchical refinement on the gated render '
                             'paths: >0 draws this many extra depths per '
                             'ray by inverse-CDF from the gated coarse '
                             "pass's compositing weights and re-evaluates "
                             'the merged set (reference fine-pass '
                             'semantics) — dense-like surface resolution '
                             'on high-frequency scenes at a fraction of '
                             'the dense MLP bill; applies to both '
                             '--occ_mode froxel and grid')
    parser.add_argument("--occ_tile", type=int, default=8,
                        help='froxel pixel-tile size: rays in a tile share '
                             'one frustum-voxel column and one top-K bin '
                             'selection')
    parser.add_argument("--train_occ", type=_str2bool, default=False,
                        help='occupancy-gated training: triage stratified '
                             'candidates through a live density grid and '
                             'train the fine network on K occupied samples '
                             'per ray (no coarse pass) — several-x rays/s '
                             'at matched time-to-quality. NDC scenes use a '
                             'grid over the NDC cube.')
    parser.add_argument("--train_occ_res", type=int, default=64,
                        help='resolution of the training density grid')
    parser.add_argument("--train_occ_until", type=int, default=0,
                        help='two-phase schedule: occupancy-gated training '
                             'until this step, then switch to the full '
                             'hierarchical trainer for the remainder '
                             '(coarse net and its Adam moments are seeded '
                             'from the trained fine net at the switch). '
                             'Buys most of the occ speedup while the final '
                             'steps recover hierarchical quality. Rounds '
                             'up to the superstep cadence (gcd of the i_* '
                             'intervals). 0 = occ for the whole run')
    parser.add_argument("--train_occ_candidates", type=int, default=64,
                        help='stratified candidates per ray triaged through '
                             'the training grid')
    parser.add_argument("--train_occ_keep", type=int, default=32,
                        help='network samples per ray: occupied candidates '
                             'kept (chosen uniformly at random, depth-'
                             'ordered)')
    parser.add_argument("--train_occ_warmup", type=int, default=2000,
                        help='train with a fully-occupied grid for this many '
                             'first steps: early training drives density to '
                             'zero everywhere (white-background phase) and a '
                             'grid that sparsifies then starves training')
    parser.add_argument("--train_occ_warmup_noise", type=float, default=1.0,
                        help='sigma noise std during the warmup steps: at '
                             'the torch-parity init sigma is negative '
                             'everywhere (zero relu gradient), so noiseless '
                             'fine-only training may freeze at background; '
                             'noise makes the escape deterministic')
    parser.add_argument("--train_occ_explore", type=float, default=0.02,
                        help='epsilon-greedy floor: probability of sampling '
                             'a grid-empty candidate anyway, so wrongly-'
                             'empty regions can recover density')
    parser.add_argument("--train_occ_decay", type=float, default=0.95,
                        help='EMA decay of the training density grid per '
                             'refresh (refreshed once per dispatch)')
    parser.add_argument("--train_occ_budget", type=_str2bool, default=False,
                        help='candidate budgeting: weight the random-K '
                             'selection by the EMA density (exponential-'
                             'race weighted sampling) so the K-sample '
                             'budget concentrates on high-density '
                             'candidates; a floor keeps coverage')
    parser.add_argument("--train_occ_probe_budget", type=int, default=0,
                        help='probe at most this many random grid cells '
                             'per density refresh (0 = whole grid); the '
                             'scaling valve for grids above 64^3')
    parser.add_argument("--fused_backward", type=_str2bool, default=None,
                        help='train through the hand-written CUDA kernels: '
                             'B1 (fused encoder + MLP forward) and B2 (fused '
                             'backward, forward rematerialised per tile, '
                             'fp32). Default: auto — ON for the MLP family '
                             'on --device cuda; on the CPU the kernels\' '
                             'plain versions (apply_nerf and autograd) run '
                             'whatever the flag says')
    parser.add_argument("--remat", type=_str2bool, default=False,
                        help='rematerialize the grid families\' encode and '
                             'decoder in backward (torch.utils.checkpoint) '
                             'to train larger ray batches; the MLP '
                             'family\'s backward kernel B2 rematerialises '
                             'its forward itself')
    parser.add_argument("--debug_nans", type=_str2bool, default=False,
                        help='enable jax_debug_nans: re-run NaN-producing '
                             'ops un-jitted and raise at the source '
                             '(the reference DEBUG NaN scan, made exact)')
    parser.add_argument("--ckpt_format", type=str, default='both',
                        choices=['native', 'tar', 'both'],
                        help='checkpoint format: native .npz, reference-'
                             'compatible .tar, or both')
    parser.add_argument("--multihost", type=_str2bool, default=False,
                        help='initialize jax.distributed (coordinator from '
                             'cluster env vars) and build the mesh over ALL '
                             "hosts' devices; a no-op on a single host")
    return parser
