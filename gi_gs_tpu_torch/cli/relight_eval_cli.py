"""Relighting metrics (port of gi_gs_tpu/cli/relight_eval_cli.py; ref
relight_eval.py:20-87): PSNR, SSIM and, with `--lpips_weights`, LPIPS of
the relit frames against GT renders at the TensoIR test ids (every 10th
frame), on `--device` (default: the card).

The fork's environment hooks and file naming are kept as they are:
DATASET and MAP_NAME pick the GT `--gt_dir/<DATASET>/<MAP_NAME>/r_{fid:04}.png`
and the prediction `--output_dir/r_{fid:04}_<MAP_NAME>.png`; the metrics
go to `relight/<DATASET>/relight_FROM_<DATA_SUBDIR>/relight_TO_<MAP_NAME>/
<MAP_NAME>.json` under the current directory. GT frames of another size
are resized to `--size` with PIL's bilinear filter.

    MAP_NAME=sunset DATASET=lego python -m \
        gi_gs_tpu_torch.cli.relight_eval_cli --output_dir PRED --gt_dir GT
"""
from __future__ import annotations

import json
import os
from argparse import ArgumentParser

import numpy as np
import torch

from ..utils import image_utils
from ..utils import lpips as lpips_mod
from ..utils.device import resolve_device
from ..utils.image_io import read_png


def _resize_bilinear(gt: np.ndarray, size: int) -> np.ndarray:
    """JAX's GT resize, float in [0, 1] -> uint8 (truncated) -> PIL
    BILINEAR to size x size -> float in [0, 1]."""
    from PIL import Image
    img = Image.fromarray((gt * 255).astype(np.uint8)).resize(
        (size, size), Image.BILINEAR)
    return np.asarray(img) / 255.0


def main(argv=None):
    parser = ArgumentParser(description="gi_gs_tpu_torch relight evaluation")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--gt_dir", type=str, required=True)
    parser.add_argument("--num_test", type=int, default=0)
    parser.add_argument("--size", type=int, default=400)
    parser.add_argument("--lpips_weights", type=str, default="",
                        help="VGG-LPIPS weights file (.npz or torch .pt); "
                             "lpips_avg is null when absent")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    lw = lpips_mod.maybe_load(args.lpips_weights)

    data_subdir = os.environ.get("DATA_SUBDIR", "")
    map_name = os.environ.get("MAP_NAME", "")
    dataset = os.environ.get("DATASET", "")
    num_test = args.num_test or (9 if "spheres" in dataset else 15)

    psnr_sum, ssim_sum, lpips_sum, n = 0.0, 0.0, 0.0, 0
    for idx in range(num_test):
        fid = 10 * (idx + 1)
        pred_path = os.path.join(args.output_dir, f"r_{fid:04}_{map_name}.png")
        gt_path = os.path.join(args.gt_dir, dataset, map_name,
                               f"r_{fid:04}.png")
        if not (os.path.exists(pred_path) and os.path.exists(gt_path)):
            continue
        pred = read_png(pred_path)[..., :3] / 255.0
        gt = read_png(gt_path)[..., :3] / 255.0
        if gt.shape[0] != args.size:
            gt = _resize_bilinear(gt, args.size)
        p = torch.as_tensor(pred.transpose(2, 0, 1), dtype=torch.float32,
                            device=device)
        g = torch.as_tensor(gt.transpose(2, 0, 1), dtype=torch.float32,
                            device=device)
        psnr_sum += float(image_utils.psnr(p, g))
        ssim_sum += float(image_utils.ssim(p, g))
        if lw is not None:
            lpips_sum += lpips_mod.lpips(p, g, lw)
        n += 1
    if n == 0:
        raise FileNotFoundError(
            f"no prediction/GT pairs in {args.output_dir} and {args.gt_dir}")
    metrics = {"psnr_avg": psnr_sum / n, "ssim_avg": ssim_sum / n,
               "lpips_avg": (lpips_sum / n) if lw is not None else None}
    print(metrics)
    out_dir = os.path.join("relight", dataset, f"relight_FROM_{data_subdir}",
                           f"relight_TO_{map_name}")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{map_name}.json")
    with open(out_path, "w") as f:
        json.dump(metrics, f, indent=4)
    return dict(metrics, n=n, path=out_path)


if __name__ == "__main__":
    main()
