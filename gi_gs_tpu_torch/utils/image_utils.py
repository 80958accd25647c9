"""Image metrics, losses and small-window filters on channel-first
[C, H, W] tensors (port of gi_gs_tpu/utils/image_utils.py: L1, PSNR,
SSIM, kornia-style median and bilateral blurs, erosion, average pooling).
Everything here is differentiable; the median network and the clamps of
differentiated values use torch.minimum/maximum, whose gradient at a tie
splits like jnp.minimum/maximum."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import timing


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x - y).abs().mean()


def psnr(img: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-image PSNR of the flattened MSE."""
    mse = ((img - gt) ** 2).mean()
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


def _gaussian_1d(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.array([math.exp(-((x - window_size // 2) ** 2) / (2 * sigma ** 2))
                  for x in range(window_size)], dtype=np.float32)
    return g / g.sum()


def _same_conv2d_separable(img: torch.Tensor, g: torch.Tensor
                           ) -> torch.Tensor:
    """Depthwise zero-padded 'same' conv of [C, H, W] with g (x) g, as two
    rank-1 passes."""
    C = img.shape[0]
    k = g.shape[0]
    pad = k // 2
    out = F.conv2d(img[None], g.reshape(1, 1, k, 1).expand(C, 1, k, 1),
                   padding=(pad, 0), groups=C)
    out = F.conv2d(out, g.reshape(1, 1, 1, k).expand(C, 1, 1, k),
                   padding=(0, pad), groups=C)
    return out[0]


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11
         ) -> torch.Tensor:
    """Mean SSIM over [C, H, W] images in [0, 1] (11x11 gaussian window,
    sigma 1.5, C1 = 0.01^2, C2 = 0.03^2; ref utils/loss_utils.py)."""
    with timing.span("sync.ssim_window"):               # a host copy
        g = torch.as_tensor(_gaussian_1d(window_size), device=img1.device)
    stack = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2],
                      dim=0)
    C = img1.shape[0]
    m = _same_conv2d_separable(stack, g)
    mu1, mu2 = m[0:C], m[C:2 * C]
    e11, e22, e12 = m[2 * C:3 * C], m[3 * C:4 * C], m[4 * C:5 * C]
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = e11 - mu1_sq
    sigma2_sq = e22 - mu2_sq
    sigma12 = e12 - mu1_mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return ssim_map.mean()


def _shift_stack_3x3(img: torch.Tensor) -> torch.Tensor:
    """[C, H, W] -> [9, C, H, W] reflect-padded 3x3 neighbourhoods
    (kornia's default border_type='reflect')."""
    H, W = img.shape[1:]
    p = F.pad(img[None], (1, 1, 1, 1), mode="reflect")[0]
    return torch.stack([p[:, dy:dy + H, dx:dx + W]
                        for dy in range(3) for dx in range(3)], dim=0)


def _median9(p):
    """Median of 9 same-shaped tensors by Paeth's 19-exchange network."""
    p = list(p)
    for i, j in ((1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2),
                 (4, 5), (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4),
                 (2, 5), (4, 7), (4, 2), (6, 4), (4, 2)):
        a, b = p[i], p[j]
        p[i] = torch.minimum(a, b)
        p[j] = torch.maximum(a, b)
    return p[4]


def median_blur_3x3(img: torch.Tensor) -> torch.Tensor:
    """3x3 median filter of [C, H, W] (kornia.filters.median_blur)."""
    return _median9(_shift_stack_3x3(img).unbind(0))


def bilateral_blur_3x3(img: torch.Tensor, sigma_color: float = 1.0,
                       sigma_space: tuple = (3.0, 3.0)) -> torch.Tensor:
    """3x3 bilateral filter of [C, H, W] (kornia.filters.bilateral_blur:
    L2 colour distance over channels, unnormalised spatial gaussian)."""
    stack = _shift_stack_3x3(img)
    diff = stack - img[None]
    color_dist_sq = (diff ** 2).sum(dim=1, keepdim=True)
    color_w = torch.exp(-0.5 * color_dist_sq / (sigma_color ** 2))
    offs = np.array([(dy - 1, dx - 1) for dy in range(3) for dx in range(3)],
                    np.float32)
    space_w = np.exp(-0.5 * (offs[:, 0] ** 2 / sigma_space[0] ** 2 +
                             offs[:, 1] ** 2 / sigma_space[1] ** 2)
                     ).astype(np.float32)
    with timing.span("sync.bilateral_weights"):         # a host copy
        space_w = torch.as_tensor(space_w, device=img.device)
    w = color_w * space_w[:, None, None, None]
    ws = w.sum(dim=0)
    return (stack * w).sum(dim=0) / torch.maximum(ws, torch.full_like(ws, 1e-8))


def erode(mask: torch.Tensor, kernel_size: int = 7) -> torch.Tensor:
    """Min-pool erosion of a [1, H, W] float mask, 'same' padding of 1s
    (kornia.morphology.erosion with an all-ones kernel, ref
    train.py:134-136)."""
    pad = kernel_size // 2
    padded = F.pad(mask[None], (pad, pad, pad, pad), value=1.0)
    return -F.max_pool2d(-padded, kernel_size, stride=1)[0]


def avg_pool2d(img: torch.Tensor, k: int) -> torch.Tensor:
    """Non-overlapping average pool of [C, H, W] (F.avg_pool2d)."""
    return F.avg_pool2d(img[None], k, stride=k)[0]
