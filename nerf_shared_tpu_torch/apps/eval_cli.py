"""Test-set evaluation CLI: render the held-out views of a trained
checkpoint and report PSNR / SSIM per view and on average.

Counterpart of ``nerf_shared_tpu/apps/eval_cli.py``:

    python -m nerf_shared_tpu_torch.apps.eval_cli --config configs/fern.txt \
        [--eval_out metrics.json] [--render_factor N] [--device cuda]

It renders through the export path (``render_only`` with the test-set
pose swap forced, on ``--device``; the occupancy engines with
``--occ_grid``) and computes the metrics on the float renders, not on the
saved 8-bit PNGs. With ``--render_factor`` the ground truth is
area-downsampled (``resize_area``) to the render's size. PSNR is capped at
120 dB (a bit-exact render is infinite, which JSON cannot carry). The
report goes to ``--eval_out``, default <basedir>/<expname>/eval_<step>.json.
Under torchrun with ``--mesh_shape N`` the renders split over the ranks
(``render_only``) and rank 0 alone prints the report and writes it:

    torchrun --nproc_per_node 2 -m nerf_shared_tpu_torch.apps.eval_cli \
        --config configs/fern.txt --mesh_shape 2
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from nerf_shared_tpu_torch.config import config_parser


def extend_parser_for_eval(parser):
    parser.add_argument("--eval_out", type=str, default="",
                        help="metrics JSON path; default"
                             " <basedir>/<expname>/eval_<step>.json")
    return parser


def run_eval(args):
    """The report (a dict), or None on a rank > 0 of a world."""
    from nerf_shared_tpu_torch.apps.train import render_only
    from nerf_shared_tpu_torch.data.datasets import load_datasets
    from nerf_shared_tpu_torch.data.images import resize_area
    from nerf_shared_tpu_torch.utils.metrics import img2mse, mse2psnr, ssim

    # evaluation is against the held-out views by definition: force the
    # render_test pose swap (data/datasets.py) whatever the flags say
    args.render_only = True
    args.render_test = True
    ds = load_datasets(args)
    outdir, rgbs = render_only(args, return_rgbs=True, ds=ds)
    if rgbs is None:  # a rank > 0: rank 0 reports
        return None

    gt = np.asarray(ds.images[ds.i_test], np.float32)
    rgbs = np.asarray(rgbs, np.float32)
    if rgbs.shape[0] != gt.shape[0]:
        raise RuntimeError(f"rendered {rgbs.shape[0]} views but the test split has "
                           f"{gt.shape[0]}")
    if rgbs.shape[1:3] != gt.shape[1:3]:  # --render_factor downscale
        gt = np.stack([resize_area(g, rgbs.shape[1], rgbs.shape[2]) for g in gt])

    rows = []
    for i, (r, g) in enumerate(zip(rgbs, gt)):
        r, g = torch.from_numpy(r), torch.from_numpy(g)
        rows.append({"view": int(ds.i_test[i]),
                     "psnr": min(float(mse2psnr(img2mse(r, g))), 120.0),
                     "ssim": float(ssim(r, g))})
    report = {
        "step": int(os.path.basename(outdir).rsplit("_", 1)[-1]),
        "n_views": len(rows),
        "mean_psnr": float(np.mean([r["psnr"] for r in rows])),
        "mean_ssim": float(np.mean([r["ssim"] for r in rows])),
        "views": rows,
        "render_dir": outdir,
    }

    out = args.eval_out or os.path.join(args.basedir, args.expname,
                                        f"eval_{report['step']:06d}.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    for r in rows:
        print(f"view {r['view']:3d}: PSNR {r['psnr']:6.2f} dB  SSIM {r['ssim']:.4f}")
    print(f"mean over {report['n_views']} views: PSNR {report['mean_psnr']:.2f} dB  "
          f"SSIM {report['mean_ssim']:.4f}  -> {out}")
    return report


def main(argv=None):
    return run_eval(extend_parser_for_eval(config_parser()).parse_args(argv))


if __name__ == "__main__":
    main()
