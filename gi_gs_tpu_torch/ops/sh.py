"""Real spherical harmonics up to degree 3 (port of gi_gs_tpu/ops/sh.py;
ref computeColorFromSH, cuda_rasterizer/forward.cu:22-80, and its
backward, cuda_rasterizer/backward.cu:20-140).

The colour of each Gaussian is one autograd Function (`_SHColour`) over
the DC and the rest coefficients as two inputs, so that no [N, K, 3]
concatenation is made, with a backward derived by hand. Its products
over the coefficients are elementwise products and sums, not batched
matrix products: a batch of millions of 1xK by Kx3 products goes to the
BLAS as that many tiny problems. Its forward is the span `sh` and its
backward the span `sh_bwd` (utils/timing)."""
from __future__ import annotations

import torch

from ..utils import timing

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
# the direction's squared norm is floored here before its rsqrt
MIN_NORM2 = 1e-24


def sh_basis(deg: int, dirs: torch.Tensor) -> torch.Tensor:
    """[..., 3] unit directions -> [..., (deg+1)^2] basis values with the
    3DGS sign conventions."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, SH_C0)]
    if deg > 0:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if deg > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy = x * y
        out += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(out, dim=-1)


def sh_basis_grad(deg: int, dirs: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """The gradient to the direction [N, 3] from v [N, (deg+1)^2 - 1], the
    gradient to the basis values past the constant one: v_k times the
    derivative of `sh_basis`'s k-th value, summed over k (backward.cu's
    dRGBdx, dRGBdy, dRGBdz dotted with dL_dRGB)."""
    x, y, z = dirs.unbind(-1)
    v = v.unbind(-1)
    gx = -SH_C1 * v[2]
    gy = -SH_C1 * v[0]
    gz = SH_C1 * v[1]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        gx = gx + (SH_C2[0] * y * v[3] - 2.0 * SH_C2[2] * x * v[5]
                   + SH_C2[3] * z * v[6] + 2.0 * SH_C2[4] * x * v[7])
        gy = gy + (SH_C2[0] * x * v[3] + SH_C2[1] * z * v[4]
                   - 2.0 * SH_C2[2] * y * v[5] - 2.0 * SH_C2[4] * y * v[7])
        gz = gz + (SH_C2[1] * y * v[4] + 4.0 * SH_C2[2] * z * v[5]
                   + SH_C2[3] * x * v[6])
    if deg > 2:
        gx = gx + (6.0 * SH_C3[0] * xy * v[8] + SH_C3[1] * yz * v[9]
                   - 2.0 * SH_C3[2] * xy * v[10]
                   - 6.0 * SH_C3[3] * xz * v[11]
                   + SH_C3[4] * (4.0 * zz - 3.0 * xx - yy) * v[12]
                   + 2.0 * SH_C3[5] * xz * v[13]
                   + 3.0 * SH_C3[6] * (xx - yy) * v[14])
        gy = gy + (3.0 * SH_C3[0] * (xx - yy) * v[8] + SH_C3[1] * xz * v[9]
                   + SH_C3[2] * (4.0 * zz - xx - 3.0 * yy) * v[10]
                   - 6.0 * SH_C3[3] * yz * v[11]
                   - 2.0 * SH_C3[4] * xy * v[12]
                   - 2.0 * SH_C3[5] * yz * v[13]
                   - 6.0 * SH_C3[6] * xy * v[14])
        gz = gz + (SH_C3[1] * xy * v[9] + 8.0 * SH_C3[2] * yz * v[10]
                   + 3.0 * SH_C3[3] * (2.0 * zz - xx - yy) * v[11]
                   + 8.0 * SH_C3[4] * xz * v[12]
                   + SH_C3[5] * (xx - yy) * v[13])
    return torch.stack([gx, gy, gz], dim=-1)


def _passed(g: torch.Tensor, x: torch.Tensor, floor: float) -> torch.Tensor:
    """g as torch.maximum(x, floor) passes it back to x: whole above the
    floor, halved at it (a tie splits the gradient, as in jnp.maximum),
    none below."""
    return torch.where(x > floor, g, torch.where(x == floor, 0.5 * g, 0.0))


class _SHColour(torch.autograd.Function):
    """Clamped RGB of N Gaussians from features_dc [N, 1, 3] and
    features_rest [N, K-1, 3] at the active degree deg, seen from campos:
    coefficients past (deg+1)^2 take no part and get a zero gradient, and
    campos gets none."""

    @staticmethod
    def forward(ctx, deg, dc, rest, means, campos):
        with timing.span("sh"):
            d = means - campos
            n2 = (d * d).sum(-1, keepdim=True)
            inv = torch.rsqrt(n2.clamp_min(MIN_NORM2))
            dirs = d * inv
            basis = sh_basis(deg, dirs)
            B = basis.shape[-1]
            rgb = basis[:, :1] * dc[:, 0]
            if B > 1:
                rgb = rgb + (basis[:, 1:, None] * rest[:, :B - 1]).sum(1)
            rgb = rgb + 0.5
            ctx.deg = deg
            ctx.save_for_backward(rest, basis, dirs, inv, n2, rgb)
            return rgb.clamp_min(0.0)

    @staticmethod
    @timing.spanned("sh_bwd")
    def backward(ctx, g):
        rest, basis, dirs, inv, n2, rgb = ctx.saved_tensors
        B = basis.shape[-1]
        g = _passed(g, rgb, 0.0)
        g_dc = g_rest = g_means = None
        if ctx.needs_input_grad[1]:
            g_dc = basis[:, :1, None] * g[:, None]
        if ctx.needs_input_grad[2]:
            outer = basis[:, 1:, None] * g[:, None]
            if B - 1 == rest.shape[1]:
                g_rest = outer
            else:
                g_rest = rest.new_zeros(rest.shape)
                g_rest[:, :B - 1] = outer
        if ctx.needs_input_grad[3] and B > 1:    # degree 0: no direction
            v = (rest[:, :B - 1] * g[:, None]).sum(-1)
            g_dirs = sh_basis_grad(ctx.deg, dirs, v)
            along = _passed((g_dirs * dirs).sum(-1, keepdim=True), n2,
                            MIN_NORM2)
            g_means = inv * (g_dirs - dirs * along)
        return None, g_dc, g_rest, g_means, None


def sh_to_rgb(deg: int, features_dc: torch.Tensor,
              features_rest: torch.Tensor, means: torch.Tensor,
              campos: torch.Tensor) -> torch.Tensor:
    """Per-Gaussian clamped RGB [N, 3] as the rasterizer preprocess
    computes it: dir = normalize(mean - campos), the SH value of
    features_dc [N, 1, 3] and features_rest [N, K-1, 3] at degree deg,
    +0.5 offset, clamp at 0."""
    return _SHColour.apply(deg, features_dc, features_rest, means, campos)


def rgb_to_sh0(rgb: torch.Tensor) -> torch.Tensor:
    """Inverse of the DC term mapping (utils/sh_utils.py RGB2SH)."""
    return (rgb - 0.5) / SH_C0
