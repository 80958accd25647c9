"""Normal mean-angular-error evaluation (the port's own numpy copy of
gi_gs_tpu/cli/normal_eval_cli.py; ref normal_eval.py:11-80, TensoIR
protocol): GT `--gt_dir/test_<id>/normal.png` with alpha against the
predicted `--output_dir/normal/{id:05d}_normal.png` and
`{id:05d}_from_depth.png`; writes `--output_dir/normal_mae.json`.

    python -m gi_gs_tpu_torch.cli.normal_eval_cli --output_dir OUT \
        --gt_dir GT
"""
from __future__ import annotations

import glob
import json
import os
from argparse import ArgumentParser

import numpy as np

from ..utils.image_io import read_png


def get_mae(gt: np.ndarray, pred: np.ndarray) -> float:
    return float(np.mean(np.arccos(
        np.clip(np.sum(gt * pred, axis=-1), -1, 1)) * 180 / np.pi))


def _load_unit_normal(path: str, flat_fill=(0.0, 0.0, 1.0)) -> np.ndarray:
    img = read_png(path)
    n = img[..., :3] / 255.0 * 2.0 - 1.0
    # (128,128,255) pixels are the encoded flat background (the 128/255
    # rounding trick, normal_eval.py:54-56)
    mask = (img[..., :3] == np.array([128, 128, 255], np.uint8)).all(-1)
    n[mask] = np.array(flat_fill)
    return n / np.linalg.norm(n, axis=-1, keepdims=True)


def main(argv=None):
    parser = ArgumentParser(description="gi_gs_tpu_torch normal evaluation")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--gt_dir", type=str, required=True)
    args = parser.parse_args(argv)

    test_dirs = sorted(glob.glob(os.path.join(args.gt_dir, "test_*")))
    gt_stack, gs_stack, fd_stack = [], [], []
    normal_bg = np.array([0.0, 0.0, 1.0])
    for test_dir in test_dirs:
        test_id = int(test_dir.split("_")[-1])
        gt_img = read_png(os.path.join(test_dir, "normal.png"))
        gt = gt_img[..., :3] / 255.0 * 2.0 - 1.0
        alpha = gt_img[..., [-1]] / 255.0
        gt = gt * alpha + normal_bg * (1.0 - alpha)
        gt_stack.append(gt / np.linalg.norm(gt, axis=-1, keepdims=True))
        gs_stack.append(_load_unit_normal(os.path.join(
            args.output_dir, "normal", f"{test_id:05d}_normal.png")))
        fd_stack.append(_load_unit_normal(os.path.join(
            args.output_dir, "normal", f"{test_id:05d}_from_depth.png")))

    mae_gs = get_mae(np.stack(gt_stack), np.stack(gs_stack))
    mae_fd = get_mae(np.stack(gt_stack), np.stack(fd_stack))
    print(f"MAE: gs={mae_gs}; from_depth={mae_fd}")
    with open(os.path.join(args.output_dir, "normal_mae.json"), "w") as f:
        json.dump({"mae_gs": mae_gs, "mae_from_depth": mae_fd}, f, indent=4)
    return {"mae_gs": mae_gs, "mae_from_depth": mae_fd}


if __name__ == "__main__":
    main()
