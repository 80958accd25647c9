"""Brute-force per-pixel splatting oracle for tests (port of
gi_gs_tpu/ops/rasterize/reference.py).

Independent of the tiled pipeline: sorts ALL Gaussians globally by view
depth and alpha-composites every one of them per pixel with the exact
CUDA rules (power/alpha cutoffs, 1e-4 transmittance early-out,
forward.cu:351-399). Plain torch on any device, differentiable through
autograd. O(N * H * W) — test-size scenes only; nothing on the render
or training path calls it.
"""
from __future__ import annotations

import torch

from .config import RasterConfig
from .preprocess import preprocess


def rasterize_bruteforce(means3d, cov3d, opacity, features, w2c, full_proj,
                         tanfovx, tanfovy, height: int, width: int,
                         cfg: RasterConfig = RasterConfig()):
    """features: [N, F]. Returns (accum [F, H, W], final_T [H, W]).

    Matches the tiled pipeline's pre-background accumulators, including
    the tile-rect coverage test (a Gaussian is only tested against pixels
    of tiles its 3-sigma rect touches, like the CUDA binning).
    """
    dev = means3d.device
    pre = preprocess(means3d, cov3d, w2c, full_proj, tanfovx, tanfovy,
                     width, height, cfg)
    key = torch.where(pre.valid, pre.depth,
                      torch.full_like(pre.depth, float("inf")))
    order = torch.argsort(key, stable=True)
    xy = pre.means2d[order]
    con = pre.conic[order]
    op = opacity[order, 0] * pre.valid[order].to(opacity.dtype)
    feat = features[order]
    rmin = pre.rect_min[order]
    rmax = pre.rect_max[order]

    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev), indexing="ij")
    tile_x = (xs / cfg.tile_w).to(torch.int32)
    tile_y = (ys / cfg.tile_h).to(torch.int32)

    t = torch.ones((height, width), dtype=torch.float32, device=dev)
    acc = torch.zeros((features.shape[1], height, width),
                      dtype=features.dtype, device=dev)
    done = torch.zeros((height, width), dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    # torch.minimum splits the gradient at a tie as jnp.minimum does
    clamp = torch.tensor(cfg.alpha_clamp, dtype=torch.float32, device=dev)
    for i in range(means3d.shape[0]):
        dx = xy[i, 0] - xs
        dy = xy[i, 1] - ys
        power = -0.5 * (con[i, 0] * dx * dx + con[i, 2] * dy * dy) \
            - con[i, 1] * dx * dy
        alpha = torch.minimum(op[i] * torch.exp(power), clamp)
        in_rect = ((tile_x >= rmin[i, 0]) & (tile_x < rmax[i, 0]) &
                   (tile_y >= rmin[i, 1]) & (tile_y < rmax[i, 1]))
        ok = (power <= 0.0) & (alpha >= cfg.alpha_min) & in_rect
        test_t = t * (1.0 - torch.where(ok, alpha, zero))
        saturate = ok & (test_t < cfg.t_min) & ~done
        contrib = ok & (test_t >= cfg.t_min) & ~done
        w = torch.where(contrib, alpha * t, zero)
        acc = acc + feat[i][:, None, None] * w[None]
        t = torch.where(contrib, test_t, t)
        done = done | saturate
    return acc, t
