"""iNeRF-style relative camera pose estimation.

Counterpart of ``nerf_shared_tpu/apps/pose_estimation.py`` (reference
examples/relative_pose_estimation_demo/demo_est_rel_pose.py): given a
frozen trained NeRF and an observed image, recover the camera pose by
minimising the photometric MSE through the differentiable renderer.

1. Keypoints -> dilated interest-region mask (host) — reference
   demo_est_rel_pose.py:35-52, 151-164. The JAX package calls OpenCV's
   SIFT detector and ``cv2.dilate``; the card's machine has no OpenCV, so
   ``find_POI`` here is the port's own difference-of-Gaussians scale-space
   extrema detector with OpenCV's documented SIFT defaults (see
   ``sift_keypoints``), and the dilation is ``scipy.ndimage``'s (equal to
   ``cv2.dilate`` given the same keypoints). A deliberate difference: the
   keypoints are close to OpenCV's, not the same.
2. Adam on the SE(3) screw parameters (w, v, theta), or on an se(3) twist,
   at lr·0.8^(k/100) at step k (the optax count schedule of the JAX app) —
   reference :74-102. Each step draws ``batch_size`` pixels of the
   interest region, builds exactly their rays from the current pose inside
   autograd and renders them through the frozen networks with noise-free
   compositing and stratified depths.
3. Rotation / translation errors against the ground truth — reference
   :105-125.

The render route is the caller's ``RenderConfig``: with ``fused_backward``
(the default on the card for the MLP family, ``config.resolve_fused_backward``)
both networks run through kernel B1 forward and kernel B2 backward, whose
point and direction gradients carry the loss to the pose, and the composite
is kernel B5; with ``--fused_backward false`` the renderer's own route (B3
forward with a plain remat backward, then B5), the JAX pose app's. On CPU
tensors the kernels' plain versions run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from nerf_shared_tpu_torch.ops.se3 import exp_se3, screw_transform
from nerf_shared_tpu_torch.render.renderer import RenderConfig, render_rays
from nerf_shared_tpu_torch.train.step import pack_ray_batch
from nerf_shared_tpu_torch.utils.metrics import img2mse

# ---------------------------------------------------------------------------
# host side: the interest region
# ---------------------------------------------------------------------------

# OpenCV's documented SIFT defaults (cv::SIFT::create)
SIFT_SIGMA = 1.6              # base blur of each octave
SIFT_INIT_SIGMA = 0.5         # blur assumed in the input image
SIFT_LAYERS = 3               # sampled scales per octave
SIFT_CONTRAST = 0.04          # contrast threshold (divided by the layers)
SIFT_EDGE = 10.0              # edge threshold on the principal-curvature ratio
SIFT_BORDER = 5               # pixels skipped at each octave's border
SIFT_INTERP_STEPS = 5         # quadratic refinement iterations


def rgb_to_gray_u8(img_rgb_u8: np.ndarray) -> np.ndarray:
    """OpenCV's RGB -> gray on uint8 in fixed point: (9798 R + 19235 G +
    3735 B + 2^14) >> 15 (0.299, 0.587, 0.114)."""
    c = img_rgb_u8.astype(np.int64)
    return ((9798 * c[..., 0] + 19235 * c[..., 1] + 3735 * c[..., 2] + (1 << 14))
            >> 15).astype(np.uint8)


def _gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian blur of a float32 image with OpenCV's kernel for a
    float image (size round(8 sigma + 1) made odd, weights normalised in
    float64) and its default border (reflect-101, scipy's 'mirror')."""
    from scipy import ndimage

    n = int(round(sigma * 8 + 1)) | 1
    x = np.arange(n, dtype=np.float64) - (n - 1) / 2
    k = np.exp(-x * x / (2 * sigma * sigma))
    k = (k / k.sum()).astype(np.float32)
    out = ndimage.correlate1d(img, k, axis=0, mode="mirror")
    return ndimage.correlate1d(out, k, axis=1, mode="mirror")


def _upsample2(img: np.ndarray) -> np.ndarray:
    """2x bilinear upsampling with OpenCV's half-pixel centres and clamped
    borders: out[2k] = (src[k-1] + 3 src[k]) / 4, out[2k+1] = (3 src[k] +
    src[k+1]) / 4."""
    def axis(a, ax):
        a = np.moveaxis(a, ax, 0)
        prev = np.concatenate([a[:1], a[:-1]], 0)
        nxt = np.concatenate([a[1:], a[-1:]], 0)
        out = np.empty((2 * a.shape[0],) + a.shape[1:], np.float32)
        out[0::2] = 0.25 * prev + 0.75 * a
        out[1::2] = 0.75 * a + 0.25 * nxt
        return np.moveaxis(out, 0, ax)

    return axis(axis(img.astype(np.float32), 0), 1)


def _refine(dogs, r: int, c: int, layer: int):
    """OpenCV's adjustLocalExtrema on one octave's DoG stack: the quadratic
    fit's offset (xc, xr) at the converged (r, c, layer), or None when the
    fit leaves the octave, does not converge, or the point fails the
    contrast or edge test."""
    img_scale = 1.0 / 255.0
    rows, cols = dogs[0].shape
    for _ in range(SIFT_INTERP_STEPS):
        img, prev, nxt = dogs[layer], dogs[layer - 1], dogs[layer + 1]
        dD = np.array([(img[r, c + 1] - img[r, c - 1]) * 0.5,
                       (img[r + 1, c] - img[r - 1, c]) * 0.5,
                       (nxt[r, c] - prev[r, c]) * 0.5], np.float64) * img_scale
        v2 = 2.0 * float(img[r, c])
        dxx = (img[r, c + 1] + img[r, c - 1] - v2) * img_scale
        dyy = (img[r + 1, c] + img[r - 1, c] - v2) * img_scale
        dss = (nxt[r, c] + prev[r, c] - v2) * img_scale
        dxy = (img[r + 1, c + 1] - img[r + 1, c - 1] - img[r - 1, c + 1]
               + img[r - 1, c - 1]) * 0.25 * img_scale
        dxs = (nxt[r, c + 1] - nxt[r, c - 1] - prev[r, c + 1] + prev[r, c - 1]) * 0.25 * img_scale
        dys = (nxt[r + 1, c] - nxt[r - 1, c] - prev[r + 1, c] + prev[r - 1, c]) * 0.25 * img_scale
        H = np.array([[dxx, dxy, dxs], [dxy, dyy, dys], [dxs, dys, dss]], np.float64)
        try:
            X = np.linalg.solve(H, dD)
        except np.linalg.LinAlgError:
            X = np.zeros(3)
        xc, xr, xi = -X
        if abs(xi) < 0.5 and abs(xr) < 0.5 and abs(xc) < 0.5:
            break
        if max(abs(xi), abs(xr), abs(xc)) > 1e8:
            return None
        c, r, layer = c + int(round(xc)), r + int(round(xr)), layer + int(round(xi))
        if (layer < 1 or layer > SIFT_LAYERS or c < SIFT_BORDER or c >= cols - SIFT_BORDER
                or r < SIFT_BORDER or r >= rows - SIFT_BORDER):
            return None
    else:
        return None
    contr = float(img[r, c]) * img_scale + 0.5 * float(dD @ np.array([xc, xr, xi]))
    if abs(contr) * SIFT_LAYERS < SIFT_CONTRAST:
        return None
    tr, det = dxx + dyy, dxx * dyy - dxy * dxy
    if det <= 0 or tr * tr * SIFT_EDGE >= (SIFT_EDGE + 1) ** 2 * det:
        return None
    return r, c, xr, xc


def sift_keypoints(gray_u8: np.ndarray) -> np.ndarray:
    """Keypoint locations [N, 2] (x, y, float, in pixels of ``gray_u8``) of
    a difference-of-Gaussians scale-space extrema detector with OpenCV's
    SIFT defaults: the image doubled first (bilinear), blurred to sigma 1.6
    assuming 0.5 already there; octaves of 3 layers (+3) down to a 4-pixel
    side, each started from the previous octave's layer 3 taken every
    other pixel; extrema over the 26 neighbours above |DoG| >
    floor(0.5 * 0.04 / 3 * 255), refined by up to 5 quadratic fits, kept at
    contrast >= 0.04 / 3 and principal-curvature ratio < 10. Orientations
    are not computed: every kept extremum is one location."""
    from scipy import ndimage

    base = _gaussian_blur(_upsample2(gray_u8.astype(np.float32)),
                          math.sqrt(max(SIFT_SIGMA ** 2 - 4 * SIFT_INIT_SIGMA ** 2, 0.01)))
    n_oct = int(round(math.log2(min(base.shape)) - 2)) + 1
    k = 2.0 ** (1.0 / SIFT_LAYERS)
    sig = [SIFT_SIGMA] + [math.sqrt((k ** i * SIFT_SIGMA) ** 2 - (k ** (i - 1) * SIFT_SIGMA) ** 2)
                          for i in range(1, SIFT_LAYERS + 3)]
    threshold = math.floor(0.5 * SIFT_CONTRAST / SIFT_LAYERS * 255)
    pts, img = [], base
    for o in range(n_oct):
        gauss = [img]
        for i in range(1, SIFT_LAYERS + 3):
            gauss.append(_gaussian_blur(gauss[-1], sig[i]))
        dogs = np.stack([gauss[i + 1] - gauss[i] for i in range(SIFT_LAYERS + 2)])
        img = gauss[SIFT_LAYERS][::2, ::2]
        rows, cols = dogs.shape[1:]
        if rows <= 2 * SIFT_BORDER or cols <= 2 * SIFT_BORDER:
            break
        mx = ndimage.maximum_filter(dogs, size=3, mode="nearest")
        mn = ndimage.minimum_filter(dogs, size=3, mode="nearest")
        ext = (np.abs(dogs) > threshold) & (((dogs > 0) & (dogs == mx))
                                            | ((dogs < 0) & (dogs == mn)))
        ext[[0, -1]] = False
        ext[:, :SIFT_BORDER] = ext[:, rows - SIFT_BORDER:] = False
        ext[:, :, :SIFT_BORDER] = ext[:, :, cols - SIFT_BORDER:] = False
        for layer, r, c in zip(*np.nonzero(ext)):
            fit = _refine(dogs, int(r), int(c), int(layer))
            if fit is not None:
                r1, c1, xr, xc = fit
                # the doubled image is octave -1: halve every coordinate
                pts.append(((c1 + xc) * 2.0 ** o / 2, (r1 + xr) * 2.0 ** o / 2))
    return np.asarray(pts, np.float64).reshape(-1, 2)


def find_POI(img_rgb_u8: np.ndarray) -> np.ndarray:
    """Keypoints -> unique integer xy pixel coords [N, 2] (reference
    demo_est_rel_pose.py:151-164), truncated as the JAX app's
    ``astype(int)`` does."""
    xy = sift_keypoints(rgb_to_gray_u8(img_rgb_u8)).astype(int)
    if xy.size == 0:
        return np.zeros((0, 2), int)
    return np.unique(xy, axis=0)


def dilate_points(poi: np.ndarray, H: int, W: int, dil_iter: int = 3,
                  kernel_size: int = 5) -> np.ndarray:
    """Pixel coords [M, 2] (x, y) of the keypoints' mask dilated
    ``dil_iter`` times by a ``kernel_size``² square with a zero border, in
    row-major order (``cv2.dilate`` with its default anchor)."""
    from scipy import ndimage

    mask = np.zeros((H, W), bool)
    mask[poi[:, 1].clip(0, H - 1), poi[:, 0].clip(0, W - 1)] = True
    # a square's anchor sits at kernel_size // 2 in OpenCV; scipy places
    # the reflected structure's centre there with origin (k - 1) // 2 - k // 2
    origin = (kernel_size - 1) // 2 - kernel_size // 2
    mask = ndimage.binary_dilation(mask, np.ones((kernel_size, kernel_size), bool),
                                   iterations=dil_iter, border_value=0, origin=origin)
    ys, xs = np.nonzero(mask)
    return np.stack([xs, ys], -1)


def interest_region_coords(img_rgb_u8: np.ndarray, dil_iter: int = 3,
                           kernel_size: int = 5,
                           sampling_strategy: str = "interest_region") -> np.ndarray:
    """Pixel coords [M, 2] (x, y) to sample the photometric loss at: the
    dilated keypoint regions, the raw keypoints, or all pixels ('random');
    a featureless image falls back to all pixels (reference
    demo_est_rel_pose.py:39-52)."""
    H, W = img_rgb_u8.shape[:2]
    ys, xs = np.mgrid[:H, :W]
    every = np.stack([xs.ravel(), ys.ravel()], -1)
    if sampling_strategy == "random":
        return every
    poi = find_POI(img_rgb_u8)
    if poi.shape[0] == 0:
        return every
    if sampling_strategy == "interest_point":
        return poi
    return dilate_points(poi, H, W, dil_iter, kernel_size)


# ---------------------------------------------------------------------------
# device side: the pose-optimisation step
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PoseOptConfig:
    batch_size: int = 512
    lrate: float = 0.01
    n_steps: int = 300
    H: int = 0
    W: int = 0
    fx: float = 0.0
    fy: float = 0.0
    cx: float = 0.0
    cy: float = 0.0

    @classmethod
    def from_K(cls, H, W, K, **kw):
        K = np.asarray(K)
        return cls(H=int(H), W=int(W), fx=float(K[0, 0]), fy=float(K[1, 1]),
                   cx=float(K[0, 2]), cy=float(K[1, 2]), **kw)


def init_pose_params(generator: torch.Generator, mode: str = "screw",
                     device=None) -> Dict[str, torch.Tensor]:
    """Near-zero pose parameters (N(0, 1) * 1e-6 from ``generator``, a CPU
    generator), as leaf tensors on ``device``: 'screw' (w, v, theta), the
    reference camera_transf; 'se3' a 6-vector twist (the lietorch
    workflow)."""
    if mode == "se3":
        shapes = {"twist": (6,)}
    elif mode == "screw":
        shapes = {"w": (3,), "v": (3,), "theta": ()}
    else:
        raise ValueError(f"unknown pose parameterization {mode!r} (screw | se3)")
    return {k: (torch.randn(s, generator=generator) * 1e-6).to(device).requires_grad_(True)
            for k, s in shapes.items()}


def apply_pose(pose_params: Dict[str, torch.Tensor], start_pose: torch.Tensor) -> torch.Tensor:
    """Current pose estimate exp(params) @ start_pose [4, 4]."""
    if "twist" in pose_params:
        T = exp_se3(pose_params["twist"])
    else:
        T = screw_transform(pose_params["w"], pose_params["v"], pose_params["theta"])
    return T @ start_pose


def _rays_for_pixels(xy: torch.Tensor, pose: torch.Tensor, cfg: PoseOptConfig):
    """World rays of integer pixel coords [N, 2] under pose [4, 4] (in the
    pose's dtype), differentiable in the pose."""
    x, y = xy[:, 0].to(pose.dtype), xy[:, 1].to(pose.dtype)
    dirs = torch.stack([(x - cfg.cx) / cfg.fx, -(y - cfg.cy) / cfg.fy,
                        -torch.ones_like(x)], dim=-1)
    rays_d = torch.einsum("nc,rc->nr", dirs, pose[:3, :3])
    rays_o = pose[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def pose_lr(pcfg: PoseOptConfig, k: int) -> float:
    """The learning rate at step k: lrate·0.8^(k/100), the reference's
    decay (set after each step for the next) as the JAX app's optax
    schedule evaluates it at Adam's count k."""
    return pcfg.lrate * 0.8 ** (k / 100.0)


def make_pose_opt_step(rcfg: RenderConfig, ccfg, fcfg, pcfg: PoseOptConfig):
    """(new_optimizer, step): ``new_optimizer(pose_params)`` is Adam(β =
    (0.9, 0.999), eps 1e-8) over the pose parameters; ``step(pose_params,
    opt, coords, image, start_pose, mparams, generator, overrides=None) ->
    loss`` is one iteration in place.

    ``coords`` [M, 2] (x, y) and ``image`` [H, W, 3] live on the device;
    ``mparams`` is {"coarse": state dict, "fine": state dict or absent},
    frozen. ``generator`` (a CPU torch.Generator) draws the batch's pixel
    indices, uploaded to the device, and the seed of the render's draws.
    ``overrides`` pins them for tests: ``idx`` [batch] indices into
    ``coords``, and the render's ``t_rand`` / ``u``."""

    def new_optimizer(pose_params):
        return torch.optim.Adam(list(pose_params.values()), lr=pcfg.lrate,
                                betas=(0.9, 0.999), eps=1e-8)

    def step(pose_params, opt, coords, image, start_pose, mparams,
             generator: torch.Generator, overrides: Optional[Dict] = None):
        overrides = dict(overrides or {})
        idx = overrides.pop("idx", None)
        if idx is None:
            idx = torch.randint(0, coords.shape[0], (pcfg.batch_size,), generator=generator)
        xy = coords[torch.as_tensor(idx).to(coords.device, non_blocking=True)]
        target = image[xy[:, 1], xy[:, 0]]
        render_gen = torch.Generator(device=image.device)
        render_gen.manual_seed(int(torch.randint(0, 1 << 62, (), generator=generator)))
        pose = apply_pose(pose_params, start_pose)
        rays_o, rays_d = _rays_for_pixels(xy, pose, pcfg)
        ray_batch = pack_ray_batch(rays_o, rays_d, rcfg, pcfg.H, pcfg.W, pcfg.fx)
        ret = render_rays(mparams["coarse"], mparams.get("fine"), ray_batch, rcfg,
                          ccfg, fcfg, overrides=overrides, generator=render_gen)
        loss = img2mse(ret["rgb_map"], target)
        first = next(iter(pose_params.values()))
        k = int(opt.state[first]["step"]) if first in opt.state else 0
        for group in opt.param_groups:
            group["lr"] = pose_lr(pcfg, k)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    return new_optimizer, step


# ---------------------------------------------------------------------------
# error metrics against the ground truth (reference demo_est_rel_pose.py:105-125)
# ---------------------------------------------------------------------------


def pose_errors(pose: np.ndarray, gt_pose: np.ndarray) -> Dict[str, float]:
    def angles(m):
        phi = np.arctan2(m[1, 0], m[0, 0]) * 180 / np.pi
        theta = (np.arctan2(-m[2, 0], np.sqrt(m[2, 1] ** 2 + m[2, 2] ** 2))
                 * 180 / np.pi)
        psi = np.arctan2(m[2, 1], m[2, 2]) * 180 / np.pi
        return phi, theta, psi

    def wrap(err):
        return abs(err) if abs(err) < 300 else abs(abs(err) - 360)

    pa, pb, pc = angles(np.asarray(pose))
    ga, gb, gc = angles(np.asarray(gt_pose))
    rot_error = wrap(ga - pa) + wrap(gb - pb) + wrap(gc - pc)
    t_pose = np.linalg.norm(np.asarray(pose)[:3, 3])
    t_gt = np.linalg.norm(np.asarray(gt_pose)[:3, 3])
    return {"rot_error_deg": float(rot_error),
            "translation_error": float(abs(t_gt - t_pose))}


# ---------------------------------------------------------------------------
# the estimation loop
# ---------------------------------------------------------------------------


def estimate_relative_pose(mparams: Dict, ccfg, fcfg, rcfg: RenderConfig,
                           sensor_image_u8: np.ndarray, start_pose: np.ndarray, K,
                           pcfg: Optional[PoseOptConfig] = None,
                           obs_img_pose: Optional[np.ndarray] = None,
                           sampling_strategy: str = "interest_region",
                           dil_iter: int = 3, kernel_size: int = 5, seed: int = 0,
                           print_every: int = 20, parameterization: str = "screw"):
    """Optimise the camera pose of ``sensor_image`` [H, W, 3] uint8 against
    frozen networks ``mparams`` ({"coarse": state dict, "fine": ...}, on
    the device the work runs on), starting from ``start_pose`` [4, 4].
    Renders without sigma noise; ``seed`` seeds the pose init and every
    draw. Returns (pose [4, 4] numpy, history: a dict of step, loss and,
    with ``obs_img_pose``, the errors every ``print_every`` steps and at
    the first)."""
    H, W = sensor_image_u8.shape[:2]
    if pcfg is None:
        pcfg = PoseOptConfig.from_K(H, W, K)
    device = next(iter(mparams["coarse"].values())).device
    frozen = {b: {k: v.detach() for k, v in sd.items()}
              for b, sd in mparams.items() if sd is not None}
    coords = torch.as_tensor(interest_region_coords(
        sensor_image_u8, dil_iter, kernel_size, sampling_strategy), device=device)
    image = torch.as_tensor(sensor_image_u8.astype(np.float32) / 255.0, device=device)
    start = torch.as_tensor(np.asarray(start_pose, np.float32), device=device)

    rcfg_frozen = dataclasses.replace(rcfg, raw_noise_std=0.0)
    new_optimizer, step = make_pose_opt_step(rcfg_frozen, ccfg, fcfg, pcfg)
    generator = torch.Generator().manual_seed(int(seed))
    pose_params = init_pose_params(generator, parameterization, device)
    opt = new_optimizer(pose_params)

    history = []
    for k in range(pcfg.n_steps):
        loss = step(pose_params, opt, coords, image, start, frozen, generator)
        if print_every and ((k + 1) % print_every == 0 or k == 0):
            with torch.no_grad():
                pose_np = apply_pose(pose_params, start).cpu().numpy()
            rec = {"step": k, "loss": float(loss)}
            if obs_img_pose is not None:
                rec.update(pose_errors(pose_np, obs_img_pose))
            history.append(rec)
            print("  ".join(f"{kk}: {vv}" for kk, vv in rec.items()))
    with torch.no_grad():
        pose = apply_pose(pose_params, start).cpu().numpy()
    return pose, history
