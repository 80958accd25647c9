"""Tile binning (port of gi_gs_tpu/ops/rasterize/binning.py): ragged
(gaussian, tile) instance expansion with the exact per-tile alpha cull,
a stable (tile, depth) sort and tile ranges.

Every Gaussian emits max(tiles_touched, 1) instances; culled ones emit
one sentinel-tile dummy, which sorts past every real tile. `expand` runs
the CUDA kernel `csrc/expand.cu` on CUDA tensors and `_expand_plain`, the
port of `_expand_xla`, on CPU tensors. The sort is one stable
`torch.sort` on the int64 key (tile << 32) | ordered_bits(depth), which
gives `lax.sort`'s two-key (tile, depth) order with ties in the original
gaussian-major order.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import cuda_kernels as ck
from .config import RasterConfig
from .preprocess import Preprocessed


class Binning(NamedTuple):
    ids: torch.Tensor          # [CAP] int32 gaussian index per sorted instance
    inst_tile: torch.Tensor    # [CAP] int32 tile id per sorted instance (T = sentinel)
    perm: torch.Tensor         # [CAP] int64 pre-sort (gaussian-major) position
    inv_perm: torch.Tensor     # [CAP] int64 inverse of perm
    tile_start: torch.Tensor   # [T] int32 first sorted row of each tile
    tile_count: torch.Tensor   # [T] int32 instances per tile (capped at cap_tile)
    offsets: torch.Tensor      # [N+1] int32 per-gaussian segment bounds
    overflow: torch.Tensor     # [] rows beyond cap_instances (incl. dummies)
    max_tile_count: torch.Tensor  # [] max per-tile population (pre-cap)
    # original gaussian of segment k, or None: segments are already in
    # original gaussian order (JAX binning.py:193-209)
    seg_gaussian: Optional[torch.Tensor] = None
    # [] rows the expansion made before the cap: (gaussian, tile) pairs
    # and one sentinel row per gaussian that touches no tile
    total: Optional[torch.Tensor] = None


def _offsets(pre: Preprocessed) -> torch.Tensor:
    counts1 = torch.clamp(pre.tiles_touched, min=1)
    cum = torch.cumsum(counts1, 0, dtype=torch.int32)
    return torch.cat([cum.new_zeros(1), cum])


def _expand_plain(pre: Preprocessed, height: int, width: int,
                  cfg: RasterConfig):
    """Port of `_expand_xla` (binning.py:62-164): returns (tile, depth,
    gid, offsets, total) with the exact f32 tile cull. Instance j belongs
    to the last gaussian g whose segment starts at or before j."""
    ty_tiles, tx_tiles = cfg.grid(height, width)
    num_tiles = ty_tiles * tx_tiles
    cap = cfg.cap_instances
    n = pre.valid.shape[0]
    dev = pre.depth.device
    fl = pre.flat

    counts = pre.tiles_touched
    offsets = _offsets(pre)
    total = offsets[-1]
    j = torch.arange(cap, dtype=torch.int32, device=dev)
    # searchsorted over the segment starts of gaussians 1..N-1 equals the
    # marker-scatter + cumsum of the XLA version.
    g = torch.searchsorted(offsets[1:n].contiguous(), j, right=True
                           ).to(torch.int32)
    g = torch.clamp(g, max=n - 1)
    gl = g.long()
    in_range = j < total

    rmin_x, rmin_y = fl.rmin_x[gl], fl.rmin_y[gl]
    rmax_eff = torch.where(counts > 0, fl.rmax_x, fl.rmin_x)[gl]
    local = j - offsets[gl]
    rw = rmax_eff - rmin_x
    rw_safe = torch.clamp(rw, min=1)
    dy = torch.div(local, rw_safe, rounding_mode="floor")
    dx = local - dy * rw_safe
    tx = rmin_x + dx
    tile_y = rmin_y + dy
    tile = tile_y * tx_tiles + tx

    # Exact tile cull: the max of the concave log-alpha over the tile's
    # pixel box lies on one of its faces (closed form per face) or is 0
    # when the mean is inside; drop the instance when op * exp(max) is
    # below alpha_min at every pixel.
    mx, my = fl.px[gl], fl.py[gl]
    cxx, cxy, cyy = fl.cxx[gl], fl.cxy[gl], fl.cyy[gl]
    op = pre.opacity[gl]
    x0 = (tx * cfg.tile_w).to(torch.float32)
    y0 = (tile_y * cfg.tile_h).to(torch.float32)
    a0, a1 = mx - (x0 + cfg.tile_w - 1), mx - x0
    b0, b1 = my - (y0 + cfg.tile_h - 1), my - y0
    tiny = torch.full_like(cxx, 1e-12)
    cxx_s = torch.where(cxx.abs() > 1e-12, cxx, tiny)
    cyy_s = torch.where(cyy.abs() > 1e-12, cyy, tiny)

    def power(dx_, dy_):
        return -0.5 * (cxx * dx_ * dx_ + cyy * dy_ * dy_) - cxy * dx_ * dy_

    def clip(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    def face_x(dx_):
        return power(dx_, clip(-cxy * dx_ / cyy_s, b0, b1))

    def face_y(dy_):
        return power(clip(-cxy * dy_ / cxx_s, a0, a1), dy_)

    fmax = torch.maximum(torch.maximum(face_x(a0), face_x(a1)),
                         torch.maximum(face_y(b0), face_y(b1)))
    inside = (a0 <= 0) & (0 <= a1) & (b0 <= 0) & (0 <= b1)
    fmax = torch.where(inside, torch.zeros_like(fmax), fmax)
    psd = (cxx > 0) & (cyy > 0) & (cxx * cyy - cxy * cxy > 0)
    keep = ~psd | (op * torch.exp(fmax) >= cfg.alpha_min)

    tile = torch.where(in_range & keep & (rw >= 1), tile,
                       torch.full_like(tile, num_tiles))
    depth = torch.where(in_range, pre.depth[gl],
                        torch.full_like(mx, float("inf")))
    return tile, depth, g, offsets, total


def expand(pre: Preprocessed, height: int, width: int, cfg: RasterConfig):
    """Instance expansion (replaces pallas_expand.expand_pallas and its
    pack_rows step): the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if not pre.depth.is_cuda:
        return _expand_plain(pre, height, width, cfg)
    ty_tiles, tx_tiles = cfg.grid(height, width)
    cap = cfg.cap_instances
    n = pre.depth.shape[0]
    dev = pre.depth.device
    fl = pre.flat
    offsets = _offsets(pre)
    cols_i = (fl.rmin_x, fl.rmin_y, fl.rmax_x, pre.tiles_touched)
    cols_f = (pre.depth, fl.px, fl.py, fl.cxx, fl.cxy, fl.cyy, pre.opacity)
    cols_i = tuple(c.contiguous() for c in cols_i)
    cols_f = tuple(c.contiguous() for c in cols_f)
    ck.check(offsets, "offsets", torch.int32, (n + 1,), dev)
    for i, c in enumerate(cols_i):
        ck.check(c, f"int column {i}", torch.int32, (n,), dev)
    for i, c in enumerate(cols_f):
        ck.check(c, f"float column {i}", torch.float32, (n,), dev)
    tile = torch.empty(cap, dtype=torch.int32, device=dev)
    depth = torch.empty(cap, dtype=torch.float32, device=dev)
    gid = torch.empty(cap, dtype=torch.int32, device=dev)
    ck.launch("expand", dev,
              offsets.data_ptr(), n, *[c.data_ptr() for c in cols_i],
              *[c.data_ptr() for c in cols_f],
              cap, tx_tiles, ty_tiles * tx_tiles, cfg.tile_w, cfg.tile_h,
              cfg.alpha_min, tile.data_ptr(), depth.data_ptr(), gid.data_ptr())
    return tile, depth, gid, offsets, offsets[-1]


def expand_resources(device: torch.device) -> dict:
    """Registers, shared memory and resident blocks per SM of the expand
    kernel (`cuda_kernels.resources`; launches nothing)."""
    return ck.resources("gigs_expand_resources", device)


def sort_key(tile: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """int64 (tile << 32) | ordered_bits(depth). ordered_bits is the
    order-preserving f32 -> u32 map (set the sign bit of non-negatives,
    invert every bit of negatives), so the key orders like lax.sort's
    total order on (tile, depth)."""
    bits = depth.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = bits >= 0x80000000
    ordered = torch.where(neg, bits ^ 0xFFFFFFFF, bits | 0x80000000)
    return (tile.to(torch.int64) << 32) | ordered


def bin_and_sort(pre: Preprocessed, height: int, width: int,
                 cfg: RasterConfig) -> Binning:
    ty_tiles, tx_tiles = cfg.grid(height, width)
    num_tiles = ty_tiles * tx_tiles
    cap = cfg.cap_instances
    dev = pre.depth.device

    tile, depth, gid, offsets, total = expand(pre, height, width, cfg)
    _, perm = torch.sort(sort_key(tile, depth), stable=True)
    sorted_tile = tile[perm]
    ids = gid[perm]
    inv_perm = torch.empty_like(perm)
    inv_perm[perm] = torch.arange(cap, dtype=perm.dtype, device=dev)

    tile_ids = torch.arange(num_tiles, dtype=torch.int32, device=dev)
    tile_start = torch.searchsorted(sorted_tile, tile_ids, right=False)
    tile_end = torch.searchsorted(sorted_tile, tile_ids, right=True)
    raw_count = (tile_end - tile_start).to(torch.int32)
    tile_count = torch.clamp(raw_count, max=cfg.cap_tile)

    return Binning(
        ids=ids, inst_tile=sorted_tile, perm=perm, inv_perm=inv_perm,
        tile_start=tile_start.to(torch.int32), tile_count=tile_count,
        offsets=offsets,
        overflow=torch.clamp(total - cap, min=0),
        max_tile_count=raw_count.max(), total=total)
