"""Tile compositing (port of gi_gs_tpu/ops/rasterize/composite.py):
front-to-back alpha blending of the 16-channel G-buffer
[color3 | ones | normal3 | albedo3 | rough | metal | depth | pos3] plus
the final transmittance, with the alpha clamp 0.99, alpha_min 1/255, the
power > 0 reject and the sticky done flag at T < 1e-4 (forward.cu:423-633),
and its backward (backward.cu:404-630).

Every function here takes a contiguous range of the image's tiles:
`tile_start` and `tile_count` hold the range's tiles, `tile_base` is the
image index of its first tile (0 for the whole image), and `grid` still
fixes the image's tile columns. The tile-sharded path
(`pipeline._composite_local_tiles`) composites one range per process; the
outputs are the range's [T_local, ...] rows (JAX's `tile_base`,
composite.py:62-75).

`composite_fwd(..., peak=True)` also returns the argmax-weight ("peak")
depth and view position of each pixel (forward.cu:577-583), for the
inference-only argmax-depth render: the kernel `composite_fwd_peak` on
CUDA tensors, `_composite_fwd_plain(..., peak=True)` (the port of
`compute_peak_depth_pos`) on CPU tensors.

`composite` is a `torch.autograd.Function` over the [N, 21] table:
* forward: `composite_fwd`, the CUDA kernel `csrc/composite_fwd.cu` on
  CUDA tensors, `_composite_fwd_plain` (the port of `_fwd_impl`, chunked
  cumulative product) on CPU tensors;
* backward: `composite_bwd`, the CUDA kernel `csrc/composite_bwd.cu` on
  CUDA tensors, `_composite_bwd_plain` (the port of `_composite_bwd`) on
  CPU tensors. Both write per-sorted-instance gradient rows [cap, 21];
  `reduce_sorted_instance_grads` then sums them per Gaussian (gather
  through inv_perm, f32 cumsum, segment differences), as in JAX: the
  CUDA kernel `csrc/reduce_instance_grads.cu` on CUDA tensors, PyTorch
  ops on CPU tensors.

The backward reproduces the CUDA reference's quirks (these ARE the
reference gradients): only the colour and opacity channels couple into
d(alpha); d(alpha)/dG ignores the 0.99 clamp; the normal cotangent is
zeroed on the 1-px border of the true image (`image_hw`, not the padded
tile grid); final_T is a differentiable output.

Per-Gaussian table columns [N, 21]: 0:2 means2d | 2:5 conic | 5 opacity |
6:9 color | 9:12 normal | 12:15 albedo | 15 rough | 16 metal | 17 depth |
18:21 pos_view. Gradient rows use the same columns.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...utils import timing
from .. import cuda_kernels as ck
from .config import RasterConfig
from .preprocess import Preprocessed

TABLE_DIM = 21
NUM_CH = 16
_COUPLED = 4          # color(3) + ones(1) channels couple into d(alpha)


def composite_table(pre: Preprocessed, opacity, color, normal, albedo,
                    roughness, metallic) -> torch.Tensor:
    """The per-Gaussian [N, 21] table `composite_fwd` reads, in the column
    order above."""
    return torch.cat([pre.means2d, pre.conic, opacity, color, normal, albedo,
                      roughness, metallic, pre.depth[:, None], pre.pos_view],
                     dim=1)


def _tile_pixel_coords(grid, cfg: RasterConfig, device, tile_base: int = 0,
                       n_local: Optional[int] = None):
    """Pixel coordinates per tile: two [T_local, P] f32 tensors (x, y) of
    the image's tiles tile_base .. tile_base + n_local - 1 (n_local: the
    whole grid by default)."""
    ty, tx = grid
    P = cfg.pixels_per_tile
    n = ty * tx if n_local is None else n_local
    t = torch.arange(tile_base, tile_base + n, dtype=torch.int32,
                     device=device)
    trow, tcol = t // tx, t % tx
    lp = torch.arange(P, dtype=torch.int32, device=device)
    ly, lx = lp // cfg.tile_w, lp % cfg.tile_w
    py = (trow[:, None] * cfg.tile_h + ly[None, :]).to(torch.float32)
    px = (tcol[:, None] * cfg.tile_w + lx[None, :]).to(torch.float32)
    return px, py


SUBTILE_PIXELS = 256   # pixels (threads) of one compositing CTA
SUBTILE_W = 16


def subtile_layout(cfg: RasterConfig) -> Tuple[int, int, int, int]:
    """(sw, sh, nx, ny): how the compositing kernels split a tile into
    nx x ny sub-tiles of sw x sh pixels, one CTA each (the rule of
    csrc/composite_walk.cuh). A tile of at most 256 pixels is one
    sub-tile; otherwise sub-tiles are 16x16, or as wide as a tile narrower
    than 16 columns (as high as a tile lower than 16 rows) and 256 pixels
    long the other way, ragged at the tile's edges: at most 8 of them."""
    w, h = cfg.tile_w, cfg.tile_h
    if w * h <= SUBTILE_PIXELS:
        return w, h, 1, 1
    sw = w if w < SUBTILE_W else (
        min(w, SUBTILE_PIXELS // h) if h < SUBTILE_W else SUBTILE_W)
    sh = min(h, SUBTILE_PIXELS // sw)
    return sw, sh, -(-cfg.tile_w // sw), -(-cfg.tile_h // sh)


def subtile_rects(cfg: RasterConfig, grid, device, tile_base: int = 0,
                  n_local: Optional[int] = None):
    """The sub-tile rectangles of every tile of the range (as
    `_tile_pixel_coords`) in image pixels, inclusive: x0, x1, y0, y1 as
    [T_local, n_sub] f64 tensors, and the sub-tile of each pixel of a
    tile, [P] int64 (pixel p = ly * tile_w + lx)."""
    sw, sh, nx, ny = subtile_layout(cfg)
    ty, tx = grid
    n = ty * tx if n_local is None else n_local
    t = torch.arange(tile_base, tile_base + n, device=device)
    trow, tcol = t // tx, t % tx
    sub = torch.arange(nx * ny, device=device)
    tx0, ty0 = (sub % nx) * sw, (sub // nx) * sh
    w = torch.clamp(cfg.tile_w - tx0, max=sw)
    h = torch.clamp(cfg.tile_h - ty0, max=sh)
    x0 = (tcol[:, None] * cfg.tile_w + tx0[None]).double()
    y0 = (trow[:, None] * cfg.tile_h + ty0[None]).double()
    lp = torch.arange(cfg.pixels_per_tile, device=device)
    pix_sub = (lp // cfg.tile_w // sh) * nx + (lp % cfg.tile_w) // sw
    return x0, x0 + (w - 1)[None], y0, y0 + (h - 1)[None], pix_sub


# Slack of the sub-tile cull (the constants of csrc/composite_walk.cuh).
_CULL_OP_SLACK = 1e-6
_CULL_TAU_ABS = 1e-5
_CULL_TAU_REL = 1e-3
_CULL_KAPPA = 64.0 / 2.0 ** 24
_CULL_PX = 0.5


def _subtile_keep_plain(rows: torch.Tensor, x0, x1, y0, y1,
                        alpha_min: float) -> torch.Tensor:
    """The compositing kernels' exact sub-tile cull: False only where no
    pixel of the rectangle [x0, x1] x [y0, y1] (inclusive; broadcast
    against rows[..., 0]) can pass the walk's f32 test `power <= 0 and
    min(clamp, op * exp(power)) >= alpha_min` for the table row. Used by
    the tests and chip_smoke.py; the CUDA path culls inside its kernels
    (`subtile_keep`, csrc/composite_walk.cuh, the same arithmetic).

    A pass needs op * G >= alpha_min with G <= 1 + 2^-22 (exp within 2
    ulp), so a row with op (1 + 1e-6) < alpha_min passes nowhere.
    Otherwise a pass needs the computed q = -2 power <= tau + 6.2e-7, tau
    = 2 ln(op / alpha_min) (taken in f32: under 1e-6 off). With C = [[a,
    b], [b, c]] positive definite and kappa = ac / det, the f32 error of q
    is at most (24 kappa + 1) 2^-24 of the exact q (each term has under 6
    roundings, and a dx^2 + c dy^2 + 2|b dx dy| <= 4 kappa q), so the
    exact q <= tau' = (tau + 1e-5) (1 + 1e-3) / (1 - 64 kappa 2^-24), and
    the pixel's offset from the mean lies in the ellipse's bounding box,
    |dx| <= sqrt(tau' c / det), |dy| <= sqrt(tau' a / det), widened by 0.5
    px. The box test is squared, in float64: a rectangle left of the box
    has u = x0 - 0.5 - mx > 0 and u^2 (det - 64 kappa 2^-24 det) > (tau +
    1e-5) (1 + 1e-3) c. A row whose conic is not positive definite or has
    64 kappa 2^-24 >= 0.5, or that holds a non-finite value, is kept
    everywhere. The binning radius (3 sigma) is not a bound: at opacity
    0.99 pixels past it still pass 1/255."""
    f32 = rows[..., 5].float()
    amin32 = torch.tensor(alpha_min, dtype=torch.float32)
    dead = f32.double() * (1.0 + _CULL_OP_SLACK) < float(amin32)
    r = rows.double()
    mx, my, a, b, c = (r[..., i] for i in range(5))
    det = a * c - b * b
    dk = det - _CULL_KAPPA * (a * c)
    bounded = (a > 0) & (dk > 0.5 * det)
    tau = ((2.0 * torch.log(f32 / amin32).double() + _CULL_TAU_ABS)
           * (1.0 + _CULL_TAU_REL))
    tx, ty = tau * c, tau * a
    left, right = x0 - _CULL_PX - mx, mx - _CULL_PX - x1
    top, bottom = y0 - _CULL_PX - my, my - _CULL_PX - y1
    outside = (((left > 0) & (left * left * dk > tx))
               | ((right > 0) & (right * right * dk > tx))
               | ((top > 0) & (top * top * dk > ty))
               | ((bottom > 0) & (bottom * bottom * dk > ty)))
    return ~(dead | (bounded & outside))


def _count_walk(work: dict, row, valid, pass_mask, t_incl, done,
                cfg: RasterConfig, rects) -> None:
    """Adds one chunk's (instance, pixel) pairs to work["pairs"]: those a
    sequential walk evaluates, valid instances up to and including the one
    that sets the pixel's done flag; and to work["culled_pairs"] those of
    them that the kernels' sub-tile cull keeps (`_subtile_keep_plain` for
    the pixel's sub-tile; `rects` is `subtile_rects`)."""
    x0, x1, y0, y1, pix_sub = rects
    ended = (pass_mask & (t_incl < cfg.t_min)).int()
    walked = (valid[..., None] & ~done[:, None, :]
              & ~((torch.cumsum(ended, dim=1) - ended) > 0))
    keep = _subtile_keep_plain(row[:, :, None, :], x0[:, None], x1[:, None],
                               y0[:, None], y1[:, None], cfg.alpha_min)
    work["pairs"] += int(walked.sum())
    work["culled_pairs"] += int((walked & keep[:, :, pix_sub]).sum())


def _features(row: torch.Tensor) -> torch.Tensor:
    """[.., K, 21] table rows -> [.., K, 16] blended feature vector."""
    ones = torch.ones(row.shape[:-1] + (1,), dtype=row.dtype,
                      device=row.device)
    return torch.cat([row[..., 6:9], ones, row[..., 9:21]], dim=-1)


def _composite_fwd_plain(table, ids, tile_start, tile_count,
                         cfg: RasterConfig, grid,
                         work: Optional[dict] = None, peak: bool = False,
                         tile_base: int = 0):
    """Port of `_fwd_impl` (composite.py:143-173). Returns accum
    [T, 16, P] and final_T [T, P]. With `work`, also counts in
    work["pairs"] the (instance, pixel) pairs evaluated before each
    pixel's done flag, and in work["culled_pairs"] those left after the
    kernels' sub-tile cull (`_count_walk`). With `peak`, also returns peak
    [T, 4, P]: the [depth, pos_view xyz] of each pixel's argmax-weight
    instance, selected as JAX's `compute_peak_depth_pos`
    (pipeline.py:66-113) does: the first maximum within a chunk, then a
    strictly greater weight across chunks."""
    dev = table.device
    T = tile_start.shape[0]
    P = cfg.pixels_per_tile
    K = cfg.chunk
    cap = ids.shape[0]
    px, py = _tile_pixel_coords(grid, cfg, dev, tile_base, T)
    max_count = int(tile_count.max()) if T else 0
    n_steps = min(-(-max_count // K), cfg.chunks_per_tile)

    t_cur = torch.ones((T, P), dtype=torch.float32, device=dev)
    done = torch.zeros((T, P), dtype=torch.bool, device=dev)
    acc = torch.zeros((T, NUM_CH, P), dtype=torch.float32, device=dev)
    kk = torch.arange(K, dtype=torch.int64, device=dev)
    max_w = torch.zeros((T, P), dtype=torch.float32, device=dev)
    pk = torch.zeros((T, 4, P), dtype=torch.float32, device=dev)
    if work is not None:
        work.update(pairs=0, culled_pairs=0)
        rects = subtile_rects(cfg, grid, dev, tile_base, T)
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
        # per channel, an ATen sum over the chunk's rows, not a BLAS
        # product: with einsum here and in the normal rotations, chip_smoke
        # phase 9's card-vs-CPU normal gradients left their tolerance once
        # opacity and scale were rounded through f64 (PERF.md section 7)
        f = _features(row)                                 # [T, K, 16]
        acc = acc + torch.stack([(f[:, :, ch, None] * w).sum(1)
                                 for ch in range(NUM_CH)], 1)
        if peak:
            # torch.argmax returns the first index of a tie
            best_k = torch.argmax(w, dim=1)                # [T, P]
            best_w = torch.gather(w, 1, best_k[:, None, :])[:, 0]
            cand = torch.gather(row[..., 17:21].transpose(1, 2), 2,
                                best_k[:, None, :].expand(T, 4, P))
            upd = best_w > max_w
            pk = torch.where(upd[:, None, :], cand, pk)
            max_w = torch.where(upd, best_w, max_w)
        if work is not None:
            _count_walk(work, row, valid, pass_mask, t_incl, done, cfg, rects)
        t_new = torch.where(contrib, t_incl, torch.full_like(t_incl,
                                                             float("inf")))
        t_cur = torch.minimum(t_new.amin(dim=1), t_cur)
        done = done | (pass_mask & (t_incl < cfg.t_min)).any(dim=1)
    return (acc, t_cur, pk) if peak else (acc, t_cur)


def composite_fwd(table: torch.Tensor, ids: torch.Tensor,
                  tile_start: torch.Tensor, tile_count: torch.Tensor,
                  cfg: RasterConfig, grid: Tuple[int, int],
                  peak: bool = False, tile_base: int = 0):
    """Blend sorted instances into per-tile accumulators (replaces
    pallas_composite.composite_fwd_pallas) for the T = tile_start.shape[0]
    tiles from image tile `tile_base` on. Returns accum [T, 16, P] and
    final_T [T, P]; with `peak` (the kernel `composite_fwd_peak`, whole
    image only) also peak [T, 4, P], each pixel's argmax-weight [depth,
    pos_view xyz]."""
    if peak and tile_base:
        raise ValueError("composite_fwd: the peak variant composites the "
                         "whole image (tile_base 0)")
    if not table.is_cuda:
        return _composite_fwd_plain(table, ids, tile_start, tile_count,
                                    cfg, grid, peak=peak, tile_base=tile_base)
    dev = table.device
    T = tile_start.shape[0]
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
    outs = (accum, final_t)
    if peak:
        outs += (torch.empty((T, 4, P), dtype=torch.float32, device=dev),)
    if T == 0:
        return outs
    name = "composite_fwd_peak" if peak else "composite_fwd"
    ck.launch(name, dev,
              table.data_ptr(), ids.data_ptr(), tile_start.data_ptr(),
              tile_count.data_ptr(), T, *(() if peak else (tile_base,)),
              cfg.chunks_per_tile * cfg.chunk, grid[1], cfg.tile_w,
              cfg.tile_h, cfg.alpha_clamp, cfg.alpha_min, cfg.t_min,
              *(o.data_ptr() for o in outs))
    return outs


def kernel_resources(kernel: str, cfg: RasterConfig,
                     device: torch.device) -> dict:
    """Registers, shared memory and resident blocks per SM of the
    compositing kernel `kernel` ("composite_fwd", "composite_fwd_peak",
    "composite_bwd", or "reduce_instance_grads": its scan kernel, whose
    shape is fixed) at cfg's tile shape (`cuda_kernels.resources`)."""
    if kernel == "reduce_instance_grads":
        return ck.resources("gigs_reduce_instance_grads_resources", device)
    if kernel == "composite_bwd":
        return ck.resources("gigs_composite_bwd_resources", device,
                            cfg.tile_w, cfg.tile_h)
    return ck.resources("gigs_composite_fwd_resources", device,
                        int(kernel == "composite_fwd_peak"), cfg.tile_w,
                        cfg.tile_h)


def _border_mask(px: torch.Tensor, py: torch.Tensor, image_hw) -> torch.Tensor:
    """[T, P] f32: 0 on the 1-px true-image border (and beyond), 1 inside
    — the CUDA edge-normal gradient skip (backward.cu:497-501)."""
    H, W = image_hw
    inside = (px > 0) & (px < W - 1) & (py > 0) & (py < H - 1)
    return inside.to(torch.float32)


def _composite_bwd_plain(table, ids, tile_start, tile_count, accum4,
                         final_t, g_acc, g_t, cfg: RasterConfig, grid,
                         image_hw, work: Optional[dict] = None,
                         tile_base: int = 0) -> torch.Tensor:
    """Port of `_composite_bwd` (composite.py:193-283) up to the sorted
    instance rows: returns [cap, 21] gradient rows, 0 outside every tile's
    (possibly cap_tile-truncated) range. With `work`, also counts the
    (instance, pixel) pairs a sequential walk evaluates, before and after
    the sub-tile cull (work["pairs"], work["culled_pairs"], as
    `_composite_fwd_plain`), and those that contribute (work["contrib"])."""
    dev = table.device
    T = tile_start.shape[0]
    P = cfg.pixels_per_tile
    K = cfg.chunk
    cap = ids.shape[0]
    px, py = _tile_pixel_coords(grid, cfg, dev, tile_base, T)
    bmask = _border_mask(px, py, image_hw)[:, None, :]
    g_acc = torch.cat([g_acc[:, :4], g_acc[:, 4:7] * bmask, g_acc[:, 7:]],
                      dim=1)
    max_count = int(tile_count.max()) if T else 0
    n_steps = min(-(-max_count // K), cfg.chunks_per_tile)

    t_cur = torch.ones((T, P), dtype=torch.float32, device=dev)
    done = torch.zeros((T, P), dtype=torch.bool, device=dev)
    prefix = torch.zeros((T, _COUPLED, P), dtype=torch.float32, device=dev)
    rows = torch.zeros((cap, TABLE_DIM), dtype=torch.float32, device=dev)
    kk = torch.arange(K, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if work is not None:
        work.update(pairs=0, culled_pairs=0, contrib=0)
        rects = subtile_rects(cfg, grid, dev, tile_base, T)
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
        a = torch.where(pass_mask, alpha, zero)
        f = _features(row)                                 # [T, K, 16]
        cp = torch.cumprod(1.0 - a, dim=1)
        t_incl = t_cur[:, None, :] * cp
        t_prev = t_cur[:, None, :] * torch.cat(
            [torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
        contrib = pass_mask & (t_incl >= cfg.t_min) & ~done[:, None, :]
        w = torch.where(contrib, a * t_prev, zero)         # [T, K, P]

        dfeat = torch.einsum("tkp,tcp->tkc", w, g_acc)     # [T, K, 16]
        wf = w[:, :, None, :] * f[:, :, :_COUPLED, None]   # [T, K, 4, P]
        prefix_incl = prefix[:, None] + torch.cumsum(wf, dim=1)
        suffix = accum4[:, None] - prefix_incl
        one_minus = torch.where(contrib, 1.0 - a, torch.ones_like(a))
        d_alpha = torch.einsum(
            "tkcp,tcp->tkp",
            f[:, :, :_COUPLED, None] * t_prev[:, :, None, :]
            - suffix / one_minus[:, :, None, :], g_acc[:, :_COUPLED])
        d_alpha = d_alpha + g_t[:, None, :] * (-final_t[:, None, :] / one_minus)
        d_alpha = torch.where(contrib, d_alpha, zero)

        # CUDA quirk: no 0.99-clamp gating (backward.cu:609,627).
        dLdG_G = row[..., 5:6] * d_alpha * G
        g_row = torch.cat([
            (dLdG_G * -(cxx * dx + cxy * dy)).sum(2, keepdim=True),
            (dLdG_G * -(cyy * dy + cxy * dx)).sum(2, keepdim=True),
            (dLdG_G * (-0.5 * dx * dx)).sum(2, keepdim=True),
            (dLdG_G * (-dx * dy)).sum(2, keepdim=True),
            (dLdG_G * (-0.5 * dy * dy)).sum(2, keepdim=True),
            (G * d_alpha).sum(2, keepdim=True),
            dfeat[..., 0:3], dfeat[..., 4:16]], dim=-1)    # [T, K, 21]
        rows[pos[valid]] = g_row[valid]
        if work is not None:
            _count_walk(work, row, valid, pass_mask, t_incl, done, cfg, rects)
            work["contrib"] += int(contrib.sum())

        prefix = prefix + wf.sum(dim=1)
        t_new = torch.where(contrib, t_incl, torch.full_like(t_incl,
                                                             float("inf")))
        t_cur = torch.minimum(t_new.amin(dim=1), t_cur)
        done = done | (pass_mask & (t_incl < cfg.t_min)).any(dim=1)
    return rows


def composite_bwd(table, ids, tile_start, tile_count, accum4, final_t,
                  g_acc, g_t, cfg: RasterConfig, grid, image_hw,
                  tile_base: int = 0) -> torch.Tensor:
    """Per-sorted-instance gradient rows [cap, 21] (replaces
    pallas_composite.composite_bwd_pallas): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. accum4 = accum[:, :4] and
    final_t are the forward's outputs for the T = tile_start.shape[0]
    tiles from image tile `tile_base` on; g_acc [T, 16, P] and g_t [T, P]
    the cotangents. Rows of instances outside the range are 0."""
    if not table.is_cuda:
        return _composite_bwd_plain(table, ids, tile_start, tile_count,
                                    accum4, final_t, g_acc, g_t, cfg, grid,
                                    image_hw, tile_base=tile_base)
    dev = table.device
    T = tile_start.shape[0]
    P = cfg.pixels_per_tile
    if P > 1024 or P % 32:
        raise ValueError(f"composite_bwd: tile {cfg.tile_h}x{cfg.tile_w} has "
                         f"{P} pixels; the kernel takes a multiple of 32, at "
                         "most 1024")
    cap = ids.shape[0]
    table, ids = table.contiguous(), ids.contiguous()
    tile_start = tile_start.to(torch.int32).contiguous()
    tile_count = tile_count.to(torch.int32).contiguous()
    accum4, final_t = accum4.contiguous(), final_t.contiguous()
    g_acc, g_t = g_acc.contiguous(), g_t.contiguous()
    ck.check(table, "table", torch.float32, (table.shape[0], TABLE_DIM), dev)
    ck.check(ids, "ids", torch.int32, (cap,), dev)
    ck.check(tile_start, "tile_start", torch.int32, (T,), dev)
    ck.check(tile_count, "tile_count", torch.int32, (T,), dev)
    ck.check(accum4, "accum4", torch.float32, (T, _COUPLED, P), dev)
    ck.check(final_t, "final_t", torch.float32, (T, P), dev)
    ck.check(g_acc, "g_acc", torch.float32, (T, NUM_CH, P), dev)
    ck.check(g_t, "g_t", torch.float32, (T, P), dev)
    rows = torch.zeros((cap, TABLE_DIM), dtype=torch.float32, device=dev)
    if T == 0:
        return rows
    H, W = image_hw
    ck.launch("composite_bwd", dev,
              table.data_ptr(), ids.data_ptr(), tile_start.data_ptr(),
              tile_count.data_ptr(), accum4.data_ptr(), final_t.data_ptr(),
              g_acc.data_ptr(), g_t.data_ptr(), T, tile_base,
              cfg.chunks_per_tile * cfg.chunk, grid[1], cfg.tile_w,
              cfg.tile_h, H, W, cfg.alpha_clamp, cfg.alpha_min, cfg.t_min,
              rows.data_ptr())
    return rows


def _scan_log_chunk(cap: int) -> int:
    """log2 of the chunk in which PyTorch's CUDA cumsum scans a [21, cap]
    tensor along its rows (get_log_num_threads_x_inner_scan: 2^x threads
    a row, x = (9 + ceil(log2 cap) - ceil(log2 21)) // 2 within [4, 9], two
    elements each): the reduction kernel scans in the same chunks, so it
    rounds as the plain version does on the card."""
    x = (9 + max(cap - 1, 0).bit_length() - 5) // 2
    return min(max(x, 4), 9) + 1


def _reduce_sorted_instance_grads_plain(g_sorted: torch.Tensor, inv_perm,
                                        offsets) -> torch.Tensor:
    """The plain reduction (composite.py:315-329): unsort to the
    gaussian-major pre-sort order (one gather through inv_perm), then
    contiguous segment sums as differences of an f32 prefix sum."""
    cap, D = g_sorted.shape
    # The scan runs along the contiguous axis of a [D, cap] copy: a CUDA
    # cumsum along dim 0 of [cap, D] scans each of the D columns in one
    # sequential thread (~0.4 s at cap 1.2M).
    g_orig = g_sorted[inv_perm].t().contiguous()
    csum = torch.cumsum(g_orig, dim=1, dtype=torch.float32)
    csum = torch.cat([csum.new_zeros((D, 1)), csum], dim=1)
    lo = torch.clamp(offsets[:-1].long(), 0, cap)
    hi = torch.clamp(offsets[1:].long(), 0, cap)
    return (csum[:, hi] - csum[:, lo]).t()


def reduce_sorted_instance_grads(g_sorted: torch.Tensor, inv_perm,
                                 offsets) -> torch.Tensor:
    """[cap, 21] sorted-instance rows -> per-Gaussian [N, 21], as a
    [21, N]-contiguous buffer seen through .t(): row g is the difference
    of the f32 prefix sums of the unsorted rows at offsets[g + 1] and
    offsets[g] (clamped to [0, cap]). The port's binning is always in the
    original gaussian order (`Binning.seg_gaussian` is None), so no
    permutation follows. The CUDA kernel `csrc/reduce_instance_grads.cu`
    (bit-equal to the plain version on the card) for CUDA tensors; the
    plain gather, cumsum and differences for CPU tensors."""
    if not g_sorted.is_cuda:
        return _reduce_sorted_instance_grads_plain(g_sorted, inv_perm,
                                                   offsets)
    dev = g_sorted.device
    cap, n = g_sorted.shape[0], offsets.shape[0] - 1
    ck.check(g_sorted, "g_sorted", torch.float32, (cap, TABLE_DIM), dev)
    ck.check(inv_perm, "inv_perm", torch.int64, (cap,), dev)
    ck.check(offsets, "offsets", torch.int32, (n + 1,), dev)
    log_chunk = _scan_log_chunk(cap)
    chunks = -(-cap >> log_chunk)
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((TABLE_DIM, n), **f32)
    loc = torch.empty((TABLE_DIM, cap), **f32)
    tops = torch.empty((TABLE_DIM, log_chunk + 1, chunks), **f32)
    lefts = torch.empty((TABLE_DIM, log_chunk, chunks), **f32)
    ck.launch("reduce_instance_grads", dev,
              g_sorted.data_ptr(), inv_perm.data_ptr(), offsets.data_ptr(),
              n, cap, log_chunk, loc.data_ptr(), tops.data_ptr(),
              lefts.data_ptr(), out.data_ptr())
    return out.t()


class _Composite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, tile_start, tile_count, inv_perm, offsets,
                cfg, grid, image_hw, tile_base):
        accum, final_t = composite_fwd(table, ids, tile_start, tile_count,
                                       cfg, grid, tile_base=tile_base)
        ctx.save_for_backward(table, ids, tile_start, tile_count, inv_perm,
                              offsets, accum[:, :_COUPLED].contiguous(),
                              final_t)
        ctx.static = (cfg, grid, image_hw, tile_base)
        return accum, final_t

    @staticmethod
    @timing.spanned("composite_bwd")
    def backward(ctx, g_acc, g_t):
        (table, ids, tile_start, tile_count, inv_perm, offsets, accum4,
         final_t) = ctx.saved_tensors
        cfg, grid, image_hw, tile_base = ctx.static
        if g_acc is None:
            g_acc = torch.zeros(accum4.shape[0], NUM_CH, accum4.shape[2],
                                dtype=torch.float32, device=table.device)
        if g_t is None:
            g_t = torch.zeros_like(final_t)
        rows = composite_bwd(table, ids, tile_start, tile_count, accum4,
                             final_t, g_acc, g_t, cfg, grid, image_hw,
                             tile_base)
        d_table = reduce_sorted_instance_grads(rows, inv_perm, offsets)
        return (d_table,) + (None,) * 9


def composite(table: torch.Tensor, binning, cfg: RasterConfig,
              grid: Tuple[int, int], image_hw: Tuple[int, int],
              tile_base: int = 0):
    """Blend the sorted instances of `binning` (a binning.Binning) into
    per-tile accumulators for the tiles of binning.tile_start, from image
    tile `tile_base` on: accum [T, 16, P] and final_T [T, P]. The table
    is differentiable (the custom backward above; its gradient comes from
    these tiles alone); without autograd (no grad mode, or a table that
    needs no gradient) this is the forward alone."""
    if not (torch.is_grad_enabled() and table.requires_grad):
        return composite_fwd(table, binning.ids, binning.tile_start,
                             binning.tile_count, cfg, grid,
                             tile_base=tile_base)
    return _Composite.apply(table, binning.ids, binning.tile_start,
                            binning.tile_count, binning.inv_perm,
                            binning.offsets, cfg, grid, tuple(image_hw),
                            int(tile_base))
