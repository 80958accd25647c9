"""Tile compositing forward (port of gi_gs_tpu/ops/rasterize/composite.py
forward): front-to-back alpha blending of the 16-channel G-buffer
[color3 | ones | normal3 | albedo3 | rough | metal | depth | pos3] plus
the final transmittance, with the alpha clamp 0.99, alpha_min 1/255, the
power > 0 reject and the sticky done flag at T < 1e-4 (forward.cu:423-633).

`composite_fwd` runs the CUDA kernel `csrc/composite_fwd.cu` on CUDA
tensors and `_composite_fwd_plain`, the port of `_fwd_impl` (chunked
cumulative product), on CPU tensors. Forward only: the render path runs
under inference mode; the backward belongs to the training slice.

Per-Gaussian table columns [N, 21]: 0:2 means2d | 2:5 conic | 5 opacity |
6:9 color | 9:12 normal | 12:15 albedo | 15 rough | 16 metal | 17 depth |
18:21 pos_view.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import cuda_kernels as ck
from .config import RasterConfig
from .preprocess import Preprocessed

TABLE_DIM = 21
NUM_CH = 16


def composite_table(pre: Preprocessed, opacity, color, normal, albedo,
                    roughness, metallic) -> torch.Tensor:
    """The per-Gaussian [N, 21] table `composite_fwd` reads, in the column
    order above."""
    return torch.cat([pre.means2d, pre.conic, opacity, color, normal, albedo,
                      roughness, metallic, pre.depth[:, None], pre.pos_view],
                     dim=1)


def _tile_pixel_coords(grid, cfg: RasterConfig, device):
    """Pixel coordinates per tile: two [T, P] f32 tensors (x, y)."""
    ty, tx = grid
    P = cfg.pixels_per_tile
    t = torch.arange(ty * tx, dtype=torch.int32, device=device)
    trow, tcol = t // tx, t % tx
    lp = torch.arange(P, dtype=torch.int32, device=device)
    ly, lx = lp // cfg.tile_w, lp % cfg.tile_w
    py = (trow[:, None] * cfg.tile_h + ly[None, :]).to(torch.float32)
    px = (tcol[:, None] * cfg.tile_w + lx[None, :]).to(torch.float32)
    return px, py


def _features(row: torch.Tensor) -> torch.Tensor:
    """[.., K, 21] table rows -> [.., K, 16] blended feature vector."""
    ones = torch.ones(row.shape[:-1] + (1,), dtype=row.dtype,
                      device=row.device)
    return torch.cat([row[..., 6:9], ones, row[..., 9:21]], dim=-1)


def _composite_fwd_plain(table, ids, tile_start, tile_count,
                         cfg: RasterConfig, grid,
                         work: Optional[dict] = None):
    """Port of `_fwd_impl` (composite.py:143-173). Returns accum
    [T, 16, P] and final_T [T, P]. With `work`, also counts in
    work["pairs"] the (instance, pixel) pairs evaluated before each
    pixel's done flag."""
    dev = table.device
    T = tile_start.shape[0]
    P = cfg.pixels_per_tile
    K = cfg.chunk
    cap = ids.shape[0]
    px, py = _tile_pixel_coords(grid, cfg, dev)
    max_count = int(tile_count.max()) if T else 0
    n_steps = min(-(-max_count // K), cfg.chunks_per_tile)

    t_cur = torch.ones((T, P), dtype=torch.float32, device=dev)
    done = torch.zeros((T, P), dtype=torch.bool, device=dev)
    acc = torch.zeros((T, NUM_CH, P), dtype=torch.float32, device=dev)
    kk = torch.arange(K, dtype=torch.int64, device=dev)
    pairs = 0
    for c in range(n_steps):
        pos = tile_start.long()[:, None] + c * K + kk[None, :]
        valid = (c * K + kk)[None, :] < tile_count.long()[:, None]  # [T, K]
        gid = ids[torch.clamp(pos, 0, cap - 1)].long()
        row = table[gid]                                   # [T, K, 21]
        dx = row[..., 0:1] - px[:, None, :]
        dy = row[..., 1:2] - py[:, None, :]
        cxx, cxy, cyy = row[..., 2:3], row[..., 3:4], row[..., 4:5]
        power = -0.5 * (cxx * dx * dx + cyy * dy * dy) - cxy * dx * dy
        G = torch.exp(power)
        alpha = torch.clamp(row[..., 5:6] * G, max=cfg.alpha_clamp)
        pass_mask = (power <= 0.0) & (alpha >= cfg.alpha_min) & valid[..., None]
        a = torch.where(pass_mask, alpha, torch.zeros_like(alpha))
        cp = torch.cumprod(1.0 - a, dim=1)                 # [T, K, P]
        t_incl = t_cur[:, None, :] * cp
        t_prev = t_cur[:, None, :] * torch.cat(
            [torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
        contrib = pass_mask & (t_incl >= cfg.t_min) & ~done[:, None, :]
        w = torch.where(contrib, a * t_prev, torch.zeros_like(a))
        acc = acc + torch.einsum("tkc,tkp->tcp", _features(row), w)
        if work is not None:
            # pairs a sequential walk evaluates: valid instances up to and
            # including the one that sets the pixel's done flag
            ended = pass_mask & (t_incl < cfg.t_min)
            ended_before = (torch.cumsum(ended.int(), dim=1) - ended.int()) > 0
            pairs += int((valid[..., None] & ~done[:, None, :]
                          & ~ended_before).sum())
        t_new = torch.where(contrib, t_incl, torch.full_like(t_incl,
                                                             float("inf")))
        t_cur = torch.minimum(t_new.amin(dim=1), t_cur)
        done = done | (pass_mask & (t_incl < cfg.t_min)).any(dim=1)
    if work is not None:
        work["pairs"] = pairs
    return acc, t_cur


def composite_fwd(table: torch.Tensor, ids: torch.Tensor,
                  tile_start: torch.Tensor, tile_count: torch.Tensor,
                  cfg: RasterConfig, grid: Tuple[int, int]):
    """Blend sorted instances into per-tile accumulators (replaces
    pallas_composite.composite_fwd_pallas with peak=False). Returns accum
    [T, 16, P] and final_T [T, P]."""
    if not table.is_cuda:
        return _composite_fwd_plain(table, ids, tile_start, tile_count,
                                    cfg, grid)
    dev = table.device
    T = grid[0] * grid[1]
    P = cfg.pixels_per_tile
    if P > 1024:
        raise ValueError(f"composite_fwd: tile {cfg.tile_h}x{cfg.tile_w} has "
                         f"{P} pixels; the kernel takes at most 1024")
    table = table.contiguous()
    ids = ids.contiguous()
    tile_start = tile_start.to(torch.int32).contiguous()
    tile_count = tile_count.to(torch.int32).contiguous()
    ck.check(table, "table", torch.float32, (table.shape[0], TABLE_DIM), dev)
    ck.check(ids, "ids", torch.int32, (ids.shape[0],), dev)
    ck.check(tile_start, "tile_start", torch.int32, (T,), dev)
    ck.check(tile_count, "tile_count", torch.int32, (T,), dev)
    accum = torch.empty((T, NUM_CH, P), dtype=torch.float32, device=dev)
    final_t = torch.empty((T, P), dtype=torch.float32, device=dev)
    if T == 0:
        return accum, final_t
    ck.launch("composite_fwd", "gigs_composite_fwd", dev,
              table.data_ptr(), ids.data_ptr(), tile_start.data_ptr(),
              tile_count.data_ptr(), T, cfg.chunks_per_tile * cfg.chunk,
              grid[1], cfg.tile_w, cfg.tile_h, cfg.alpha_clamp,
              cfg.alpha_min, cfg.t_min, accum.data_ptr(), final_t.data_ptr())
    return accum, final_t
