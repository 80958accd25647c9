"""Training losses: edge-aware TV terms (port of
gi_gs_tpu/train/losses.py; ref train.py:83-142)."""
from __future__ import annotations

import torch

from ..utils import image_utils


def tv_loss(gt_image: torch.Tensor, prediction: torch.Tensor, pad: int = 1,
            step: int = 1) -> torch.Tensor:
    """Edge-aware total variation (ref get_tv_loss, train.py:83-114).
    gt_image [3, H, W], prediction [C, H, W]."""
    if pad > 1:
        gt_image = image_utils.avg_pool2d(gt_image, pad)
        prediction = image_utils.avg_pool2d(prediction, pad)
    loss = 0.0
    for s in range(1, step + 1):
        rgb_grad_h = torch.exp(-(gt_image[:, s:, :] - gt_image[:, :-s, :])
                               .abs().mean(0, keepdim=True))
        rgb_grad_w = torch.exp(-(gt_image[:, :, s:] - gt_image[:, :, :-s])
                               .abs().mean(0, keepdim=True))
        tv_h = (prediction[:, s:, :] - prediction[:, :-s, :]) ** 2
        tv_w = (prediction[:, :, s:] - prediction[:, :, :-s]) ** 2
        loss = loss + (tv_h * rgb_grad_h).mean() + (tv_w * rgb_grad_w).mean()
    return loss


def masked_tv_loss(mask: torch.Tensor, gt_image: torch.Tensor,
                   prediction: torch.Tensor, erosion: bool = False
                   ) -> torch.Tensor:
    """Masked edge-aware TV (ref get_masked_tv_loss, train.py:117-142).
    mask [1, H, W] bool/float."""
    rgb_grad_h = torch.exp(-(gt_image[:, 1:, :] - gt_image[:, :-1, :])
                           .abs().mean(0, keepdim=True))
    rgb_grad_w = torch.exp(-(gt_image[:, :, 1:] - gt_image[:, :, :-1])
                           .abs().mean(0, keepdim=True))
    tv_h = (prediction[:, 1:, :] - prediction[:, :-1, :]) ** 2
    tv_w = (prediction[:, :, 1:] - prediction[:, :, :-1]) ** 2
    m = mask.to(torch.float32)
    if erosion:
        m = image_utils.erode(m, 7)
    mask_h = m[:, 1:, :] * m[:, :-1, :]
    mask_w = m[:, :, 1:] * m[:, :, :-1]
    return (tv_h * rgb_grad_h * mask_h).mean() + \
        (tv_w * rgb_grad_w * mask_w).mean()
