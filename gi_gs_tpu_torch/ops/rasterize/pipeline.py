"""End-to-end rasterization (port of gi_gs_tpu/ops/rasterize/pipeline.py):
preprocess -> bin/sort -> composite -> G-buffer images, differentiable
with respect to the Gaussian attributes (and the `ndc_offset` hook)
through the compositing's custom backward (`argmax_depth=False`).
`argmax_depth=True` is the inference-only peak-depth render: one forward
launch (`composite_fwd` with `peak=True`) on a detached table.
`tile_group` shards the compositing over the ranks of a process group
(`_composite_local_tiles`)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .binning import Binning, bin_and_sort
from .composite import _composite_fwd_plain, composite, composite_fwd, \
    composite_table
from .config import RasterConfig
from .preprocess import preprocess
from ...parallel import collectives
from ...utils import timing
from ...utils.math_utils import rotate_chw


class RasterOutput(NamedTuple):
    color: torch.Tensor        # [3, H, W] with background composited
    opacity: torch.Tensor      # [1, H, W] accumulated weight
    depth: torch.Tensor        # [1, H, W] weight-normalised view z
    normal: torch.Tensor       # [3, H, W] accumulated world normal (raw)
    normal_view: torch.Tensor  # [3, H, W] normalised view-space normal
    pos_view: torch.Tensor     # [3, H, W] weight-normalised view position
    albedo: torch.Tensor       # [3, H, W]
    roughness: torch.Tensor    # [1, H, W] (+final_T when inference)
    metallic: torch.Tensor     # [1, H, W]
    final_t: torch.Tensor      # [1, H, W] residual transmittance
    radii: torch.Tensor        # [N] int32 screen radii (0 = culled)
    visibility: torch.Tensor   # [N] bool
    overflow: torch.Tensor     # [] dropped instances (diagnostics)
    max_tile_count: torch.Tensor  # [] (diagnostics)


def _tiles_to_image(tiles: torch.Tensor, grid, cfg: RasterConfig,
                    height: int, width: int) -> torch.Tensor:
    """[T, CH, P] -> [CH, H, W] (crop the tile padding)."""
    ty, tx = grid
    ch = tiles.shape[1]
    img = tiles.reshape(ty, tx, ch, cfg.tile_h, cfg.tile_w)
    img = img.permute(2, 0, 3, 1, 4).reshape(ch, ty * cfg.tile_h,
                                             tx * cfg.tile_w)
    return img[:, :height, :width]


def _ref_quotient(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """value num / den (den > 1e-6, else 0), gradient d/d(num) = 1: the
    CUDA backward routes the depth/pos cotangent straight to the weighted
    sum (backward.cu:590) and drops the quotient term."""
    ok = den > 1e-6
    val = torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                      torch.zeros_like(num))
    return num + (val - num).detach()


def mark_visible(means3d: torch.Tensor, w2c: torch.Tensor,
                 near: float = 0.2) -> torch.Tensor:
    """Frustum-culling visibility (ref markVisible -> in_frustum,
    rasterizer_impl.cu:790-803, auxiliary.h:150-176: near plane only)."""
    z = (means3d[:, 0] * w2c[2, 0] + means3d[:, 1] * w2c[2, 1] +
         means3d[:, 2] * w2c[2, 2] + w2c[2, 3])
    return z > near


def compute_peak_depth_pos(table: torch.Tensor, binning: Binning,
                           cfg: RasterConfig, grid, height: int, width: int):
    """Argmax-weight ("peak") depth/position selection by the plain chunked
    walk (port of JAX's jnp oracle, pipeline.py:66-113; ref
    forward.cu:577-583,619-622). Forward only. Returns (peak_depth
    [1, H, W], peak_pos [3, H, W]). `rasterize(argmax_depth=True)` takes
    the peak rows from its one compositing launch instead; this oracle is
    what the tests and the card check compare that launch with."""
    with torch.no_grad():
        _, _, pk = _composite_fwd_plain(table, binning.ids,
                                        binning.tile_start,
                                        binning.tile_count, cfg, grid,
                                        peak=True)
    img = _tiles_to_image(pk, grid, cfg, height, width)
    return img[0:1], img[1:4]


def count_instances(means3d, cov3d, w2c, full_proj, tanfovx, tanfovy,
                    height: int, width: int, cfg: RasterConfig,
                    opacity: Optional[torch.Tensor] = None) -> int:
    """Exact (gaussian, tile) instance count of one view, dummies
    included — what `cap_instances` must hold."""
    pre = preprocess(means3d, cov3d, w2c, full_proj, tanfovx, tanfovy,
                     width, height, cfg, opacity=opacity)
    return int(torch.clamp(pre.tiles_touched, min=1).sum())


CAP_QUANTUM = 1 << 16  # instance-capacity bucket granularity


def bucket_cap_instances(needed: int, headroom: float = 1.15,
                         quantum: int = CAP_QUANTUM) -> int:
    """Round a measured instance count up to a capacity bucket."""
    want = max(int(needed * headroom), quantum)
    return -(-want // quantum) * quantum


def _composite_local_tiles(table: torch.Tensor, b: Binning,
                           cfg: RasterConfig, grid, image_hw, group):
    """Tile-sharded compositing (JAX pipeline.py:148-170, a process group
    in place of a mesh axis): the image's tiles, padded with empty ones
    to a multiple of the group's size, are split into contiguous ranges;
    this rank composites its range (`tile_base` = rank x range length)
    and an all_gather reassembles every tile on every rank. The gather's
    backward keeps this rank's tiles (`collectives.all_gather_tiles`), so
    the table's gradient is this rank's partial: the caller sums the
    partial parameter gradients over the group."""
    rank, world = collectives.rank_and_size(group)
    T = grid[0] * grid[1]
    pad = (-T) % world
    t_local = (T + pad) // world
    base = rank * t_local
    local = b._replace(
        tile_start=F.pad(b.tile_start, (0, pad))[base:base + t_local],
        tile_count=F.pad(b.tile_count, (0, pad))[base:base + t_local])
    accum, final_t = composite(table, local, cfg, grid, image_hw,
                               tile_base=base)
    accum, final_t = collectives.all_gather_tiles((accum, final_t), group)
    return accum[:T], final_t[:T]


def rasterize(means3d: torch.Tensor, cov3d: torch.Tensor,
              opacity: torch.Tensor,       # [N, 1] activated
              color: torch.Tensor,         # [N, 3] per-view RGB
              normal: torch.Tensor,        # [N, 3] activated (unit)
              albedo: torch.Tensor,        # [N, 3]
              roughness: torch.Tensor,     # [N, 1]
              metallic: torch.Tensor,      # [N, 1]
              w2c: torch.Tensor, full_proj: torch.Tensor,
              tanfovx: float, tanfovy: float, height: int, width: int,
              bg_color: torch.Tensor,      # [3]
              cfg: RasterConfig,
              ndc_offset: Optional[torch.Tensor] = None,
              inference: bool = False,
              argmax_depth: bool = False,
              tile_group=None) -> RasterOutput:
    """argmax_depth is INFERENCE-ONLY (the reference has no backward for
    it, forward.cu:577-583): the table is detached and one forward launch
    gives the accumulators and the peak rows, as JAX's Pallas branch
    (pipeline.py:211-227); depth and pos_view are then the peak instance's
    where the pixel is covered (pipeline.py:254-261), and no output
    carries a gradient.

    tile_group: a torch.distributed process group (or
    `torch.distributed.group.WORLD`) to shard the compositing over by
    contiguous tile ranges, preprocess and binning running replicated on
    every rank (`_composite_local_tiles`); the gradients are then each
    rank's partials, which the caller sums
    (parallel/tile_sharded.make_ts_phase1_step). Not with argmax_depth."""
    if argmax_depth and tile_group is not None:
        raise ValueError("rasterize: argmax_depth is single-device only")
    grid = cfg.grid(height, width)
    dev = means3d.device
    with timing.stage("preprocess", dev):
        pre = preprocess(means3d, cov3d, w2c, full_proj, tanfovx, tanfovy,
                         width, height, cfg, opacity=opacity,
                         ndc_offset=ndc_offset)
    # Binning consumes integer/ordering decisions only: no gradient flows
    # through the sort keys (the CUDA binning is equally non-differentiable).
    with timing.stage("binning", dev), torch.no_grad():
        b = bin_and_sort(pre, height, width, cfg)
        timing.count("instances", b.total)
    with timing.stage("composite", dev):
        table = composite_table(pre, opacity, color, normal, albedo,
                                roughness, metallic)
        if argmax_depth:
            accum, final_t, peak = composite_fwd(
                table.detach(), b.ids, b.tile_start, b.tile_count, cfg, grid,
                peak=True)
        elif tile_group is not None:
            accum, final_t = _composite_local_tiles(
                table, b, cfg, grid, (height, width), tile_group)
        else:
            accum, final_t = composite(table, b, cfg, grid, (height, width))

    img = _tiles_to_image(accum, grid, cfg, height, width)   # [16, H, W]
    t_img = _tiles_to_image(final_t[:, None, :], grid, cfg, height, width)

    o = img[3:4]
    out_color = img[0:3] + t_img * bg_color[:, None, None]
    out_normal = img[4:7]
    out_rough = img[10:11] + (t_img if inference else 0.0)  # forward.cu:612-616
    if argmax_depth:
        pk_img = _tiles_to_image(peak, grid, cfg, height, width)
        zero = torch.zeros((), dtype=o.dtype, device=o.device)
        out_depth = torch.where(o > 1e-6, pk_img[0:1], zero)
        out_pos = torch.where(o > 1e-6, pk_img[1:4], zero)
    else:
        out_depth = _ref_quotient(img[12:13], o)
        out_pos = _ref_quotient(img[13:16], o)

    # View-space normal, normalised in the kernel with no backward path
    # (forward.cu:600-605).
    n_view = rotate_chw(w2c[:3, :3], out_normal)
    n_norm = torch.linalg.norm(n_view, dim=0, keepdim=True)
    n_view = (n_view / torch.clamp(n_norm, min=1e-12)).detach()

    return RasterOutput(
        color=out_color, opacity=o, depth=out_depth, normal=out_normal,
        normal_view=n_view, pos_view=out_pos, albedo=img[7:10],
        roughness=out_rough, metallic=img[11:12], final_t=t_img,
        radii=pre.radius, visibility=pre.radius > 0,
        overflow=b.overflow, max_tile_count=b.max_tile_count)


def rasterize_lite(means3d, cov3d, opacity, color, w2c, full_proj, tanfovx,
                   tanfovy, height: int, width: int, bg_color,
                   cfg: RasterConfig, argmax_depth: bool = False):
    """Colour/depth/opacity-only path (ref liteRenderCUDA,
    forward.cu:279-418; exposed for baking, unused by training): the full
    rasterizer with zero normal and BRDF attributes. Returns (color
    [3, H, W], opacity [1, H, W], depth [1, H, W], final_t [1, H, W])."""
    zeros3 = torch.zeros_like(color)
    zeros1 = torch.zeros_like(opacity)
    out = rasterize(means3d, cov3d, opacity, color, zeros3, zeros3, zeros1,
                    zeros1, w2c, full_proj, tanfovx, tanfovy, height, width,
                    bg_color, cfg, argmax_depth=argmax_depth)
    return out.color, out.opacity, out.depth, out.final_t
