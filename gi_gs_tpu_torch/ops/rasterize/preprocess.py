"""Per-Gaussian view preprocessing (port of
gi_gs_tpu/ops/rasterize/preprocess.py; ref preprocessCUDA + computeCov2D,
cuda_rasterizer/forward.cu:82-276): EWA projection with the 0.3 px
low-pass, near-plane cull at 0.2, screen radius, tile rect and
`tiles_touched`, plus the 1-D `PreFlat` columns the binning reads.

Scalars that are f32 arrays in the JAX version (tan fov, focal) are f32
0-d tensors here so every product rounds the same way.

Plain differentiable torch: the reference's hand-written backward
(backward.cu:145-401) is the chain rule of these ops, including its
gradient gates (the +-1.3 tan-fov clamp, the sqrt(max(0.1, .)) guard).
Clamps of differentiated values use torch.minimum/maximum, whose gradient
at a tie splits like jnp.clip/maximum (torch.clamp passes it whole); the
NaN guards on the divisions keep the unselected branches of culled rows
finite in the backward.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...utils import timing
from .config import RasterConfig


class PreFlat(NamedTuple):
    px: torch.Tensor         # [N] mean2d x
    py: torch.Tensor         # [N] mean2d y
    cxx: torch.Tensor        # [N] conic xx
    cxy: torch.Tensor        # [N] conic xy
    cyy: torch.Tensor        # [N] conic yy
    rmin_x: torch.Tensor     # [N] int32
    rmin_y: torch.Tensor     # [N] int32
    rmax_x: torch.Tensor     # [N] int32
    rmax_y: torch.Tensor     # [N] int32


class Preprocessed(NamedTuple):
    valid: torch.Tensor      # [N] bool — survives culling
    means2d: torch.Tensor    # [N, 2] pixel coords
    conic: torch.Tensor      # [N, 3] inverse cov2D (xx, xy, yy)
    depth: torch.Tensor      # [N] view-space z
    pos_view: torch.Tensor   # [N, 3]
    radius: torch.Tensor     # [N] int32 screen radius (0 when culled)
    rect_min: torch.Tensor   # [N, 2] int32 (tx, ty) inclusive
    rect_max: torch.Tensor   # [N, 2] int32 (tx, ty) exclusive
    tiles_touched: torch.Tensor  # [N] int32
    opacity: torch.Tensor    # [N] activated opacity (tile cull input)
    flat: PreFlat


def ndc2pix(v: torch.Tensor, size: int) -> torch.Tensor:
    """((v + 1) * S - 1) / 2 — auxiliary.h:41-44."""
    return ((v + 1.0) * size - 1.0) * 0.5


def compute_cov2d(p_view, cov3d, w2c, fx, fy, tanfovx, tanfovy,
                  lowpass: float):
    """EWA projection of the [N, 6] upper-tri 3D covariance; returns the
    (xx, xy, yy) columns with the low-pass added (forward.cu:83-122)."""
    tz = torch.where(p_view[:, 2] > 0.01, p_view[:, 2],
                     torch.ones_like(p_view[:, 2]))
    limx = 1.3 * tanfovx
    limy = 1.3 * tanfovy
    tx = torch.minimum(torch.maximum(p_view[:, 0] / tz, -limx), limx) * tz
    ty = torch.minimum(torch.maximum(p_view[:, 1] / tz, -limy), limy) * tz

    j00 = fx / tz
    j02 = -(fx * tx) / (tz * tz)
    j11 = fy / tz
    j12 = -(fy * ty) / (tz * tz)

    W = w2c[:3, :3]
    t0x = j00 * W[0, 0] + j02 * W[2, 0]
    t0y = j00 * W[0, 1] + j02 * W[2, 1]
    t0z = j00 * W[0, 2] + j02 * W[2, 2]
    t1x = j11 * W[1, 0] + j12 * W[2, 0]
    t1y = j11 * W[1, 1] + j12 * W[2, 1]
    t1z = j11 * W[1, 2] + j12 * W[2, 2]

    c0, c1, c2, c3, c4, c5 = cov3d.unbind(1)
    u0x = c0 * t0x + c1 * t0y + c2 * t0z
    u0y = c1 * t0x + c3 * t0y + c4 * t0z
    u0z = c2 * t0x + c4 * t0y + c5 * t0z
    u1x = c0 * t1x + c1 * t1y + c2 * t1z
    u1y = c1 * t1x + c3 * t1y + c4 * t1z
    u1z = c2 * t1x + c4 * t1y + c5 * t1z

    cxx = t0x * u0x + t0y * u0y + t0z * u0z + lowpass
    cxy = t0x * u1x + t0y * u1y + t0z * u1z
    cyy = t1x * u1x + t1y * u1y + t1z * u1z + lowpass
    return cxx, cxy, cyy


def preprocess(means3d: torch.Tensor, cov3d: torch.Tensor,
               w2c: torch.Tensor, full_proj: torch.Tensor,
               tanfovx: float, tanfovy: float, width: int, height: int,
               cfg: RasterConfig,
               opacity: Optional[torch.Tensor] = None,
               ndc_offset: Optional[torch.Tensor] = None) -> Preprocessed:
    """Project Gaussians and compute screen-space footprints. With
    `opacity` (detached: it feeds the tile cull only), the emission rect
    uses the opacity-aware radius sigma * sqrt(2 ln(op / alpha_min))
    intersected with the reference's 3-sigma rect; the reported radius
    stays ceil(3 sigma). `ndc_offset` [N, 2] is a zero-valued hook whose
    gradient is the reference's screen-space gradient (the densification
    statistic): d(px)/d(ndc_offset_x) = W/2, the CUDA ddelx_dx factor
    (backward.cu:505-506,616-617)."""
    dev = means3d.device

    def f32(v):
        with timing.span("sync.preprocess_scalar"):     # a host copy
            return torch.tensor(v, dtype=torch.float32, device=dev)

    tanfovx, tanfovy = f32(tanfovx), f32(tanfovy)
    fx = width / (2.0 * tanfovx)
    fy = height / (2.0 * tanfovy)
    ty_tiles, tx_tiles = cfg.grid(height, width)

    x, y, z = means3d[:, 0], means3d[:, 1], means3d[:, 2]

    def xform(M, row):
        return M[row, 0] * x + M[row, 1] * y + M[row, 2] * z + M[row, 3]

    view_z = xform(w2c, 2)
    p_view = torch.stack([xform(w2c, 0), xform(w2c, 1), view_z], dim=-1)
    hx, hy, hw = xform(full_proj, 0), xform(full_proj, 1), xform(full_proj, 3)
    denom = hw + 1e-7
    p_w = 1.0 / torch.where(denom.abs() > 1e-8, denom, torch.ones_like(denom))

    in_front = view_z > cfg.near

    covxx, covxy, covyy = compute_cov2d(p_view, cov3d, w2c, fx, fy,
                                        tanfovx, tanfovy, cfg.lowpass)
    det = covxx * covyy - covxy * covxy
    det_ok = det != 0.0
    det_inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic_xx = covyy * det_inv
    conic_xy = -covxy * det_inv
    conic_yy = covxx * det_inv
    conic = torch.stack([conic_xx, conic_xy, conic_yy], dim=-1)

    mid = 0.5 * (covxx + covyy)
    disc = torch.sqrt(torch.maximum(mid * mid - det, f32(0.1)))
    lambda1 = mid + disc
    sigma = torch.sqrt(torch.maximum(torch.maximum(lambda1, mid - disc),
                                     f32(1e-8)))
    radius_f = torch.ceil(3.0 * sigma)

    if opacity is None:
        op = torch.ones(means3d.shape[0], dtype=torch.float32, device=dev)
    else:
        op = opacity.detach().reshape(-1)
    s_cut = torch.sqrt(2.0 * torch.log(
        torch.clamp(op, min=cfg.alpha_min) / cfg.alpha_min))
    s_cut = torch.where(op < cfg.alpha_min, torch.zeros_like(s_cut),
                        torch.clamp(s_cut, max=3.0))
    radius_cut = torch.ceil(s_cut * sigma)

    px = ndc2pix(hx * p_w, width)
    py = ndc2pix(hy * p_w, height)
    if ndc_offset is not None:
        px = px + ndc_offset[:, 0] * (0.5 * width)
        py = py + ndc_offset[:, 1] * (0.5 * height)
    means2d = torch.stack([px, py], dim=-1)

    def to_i32(v, hi):
        return torch.clamp(v, 0, hi).to(torch.int32)

    def rect_cuda(r):
        """getRect (auxiliary.h:46-56) verbatim: truncates the float
        numerator of the exclusive bound."""
        return (to_i32((px - r) / cfg.tile_w, tx_tiles),
                to_i32((py - r) / cfg.tile_h, ty_tiles),
                to_i32((px + r + cfg.tile_w - 1) / cfg.tile_w, tx_tiles),
                to_i32((py + r + cfg.tile_h - 1) / cfg.tile_h, ty_tiles))

    def rect_exact(r):
        """Exact pixel-coverage rect for a tight radius."""
        fdiv = lambda a, b: torch.div(a, b, rounding_mode="floor")
        return (to_i32((px - r) / cfg.tile_w, tx_tiles),
                to_i32((py - r) / cfg.tile_h, ty_tiles),
                to_i32(fdiv(torch.floor(px + r), cfg.tile_w) + 1, tx_tiles),
                to_i32(fdiv(torch.floor(py + r), cfg.tile_h) + 1, ty_tiles))

    r3 = rect_cuda(radius_f)
    rc_ = rect_exact(radius_cut)
    rect_min_x = torch.maximum(rc_[0], r3[0])
    rect_min_y = torch.maximum(rc_[1], r3[1])
    rect_max_x = torch.minimum(rc_[2], r3[2])
    rect_max_y = torch.minimum(rc_[3], r3[3])
    area = (torch.clamp(rect_max_x - rect_min_x, min=0) *
            torch.clamp(rect_max_y - rect_min_y, min=0))
    area_ref = (r3[2] - r3[0]) * (r3[3] - r3[1])

    valid_vis = in_front & det_ok & (area_ref > 0)
    valid = in_front & det_ok & (area > 0)
    radius = torch.where(valid_vis, radius_f,
                         torch.zeros_like(radius_f)).to(torch.int32)
    tiles_touched = torch.where(valid, area, torch.zeros_like(area)
                                ).to(torch.int32)

    return Preprocessed(
        valid=valid, means2d=means2d, conic=conic, depth=view_z,
        pos_view=p_view, radius=radius,
        rect_min=torch.stack([rect_min_x, rect_min_y], dim=-1),
        rect_max=torch.stack([rect_max_x, rect_max_y], dim=-1),
        tiles_touched=tiles_touched, opacity=op,
        flat=PreFlat(px=px, py=py, cxx=conic_xx, cxy=conic_xy, cyy=conic_yy,
                     rmin_x=rect_min_x, rmin_y=rect_min_y,
                     rmax_x=rect_max_x, rmax_y=rect_max_y))
