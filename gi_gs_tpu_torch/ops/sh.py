"""Real spherical harmonics up to degree 3 (port of gi_gs_tpu/ops/sh.py;
ref computeColorFromSH, cuda_rasterizer/forward.cu:22-80, and its
backward, cuda_rasterizer/backward.cu:20-140).

The colour of each Gaussian is one autograd Function (`_SHColour`) over
the DC and the rest coefficients as two inputs, so that no [N, K, 3]
concatenation is made, with a backward derived by hand. On CUDA tensors
each direction is one launch of a hand-written kernel (`csrc/sh.cu`:
`sh_fwd`, `sh_bwd`), which saves nothing but the inputs and recomputes
the direction and basis in the backward, with the plain twin's bits. CPU
tensors take the plain twin (`_sh_fwd_plain`, `_sh_bwd_plain`): its
products over the coefficients are elementwise products and sums, not
batched matrix products (a batch of millions of 1xK by Kx3 products goes
to the BLAS as that many tiny problems). The forward is the span `sh`
and the backward the span `sh_bwd` (utils/timing)."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..utils import timing
from . import cuda_kernels as ck

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


def _sh_fwd_plain(deg: int, dc, rest, means, campos):
    """The clamped colour as PyTorch ops, and what `_sh_bwd_plain` reads."""
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
    return rgb.clamp_min(0.0), (rest, basis, dirs, inv, n2, rgb)


def _sh_bwd_plain(deg: int, g, saved, needs: Sequence[bool]):
    """(g_dc, g_rest, g_means) as PyTorch ops from `_sh_fwd_plain`'s saved
    tensors; None where `needs` (dc, rest, means) is False, and g_means
    None at degree 0 (no direction)."""
    rest, basis, dirs, inv, n2, rgb = saved
    B = basis.shape[-1]
    g = _passed(g, rgb, 0.0)
    g_dc = g_rest = g_means = None
    if needs[0]:
        g_dc = basis[:, :1, None] * g[:, None]
    if needs[1]:
        outer = basis[:, 1:, None] * g[:, None]
        if B - 1 == rest.shape[1]:
            g_rest = outer
        else:
            g_rest = rest.new_zeros(rest.shape)
            g_rest[:, :B - 1] = outer
    if needs[2] and B > 1:
        v = (rest[:, :B - 1] * g[:, None]).sum(-1)
        g_dirs = sh_basis_grad(deg, dirs, v)
        along = _passed((g_dirs * dirs).sum(-1, keepdim=True), n2,
                        MIN_NORM2)
        g_means = inv * (g_dirs - dirs * along)
    return g_dc, g_rest, g_means


def _inputs(dc, rest, means, campos):
    """The kernels' inputs, contiguous and checked: (dc, rest, means,
    campos, n, rows)."""
    dev = means.device
    dc, rest, means, campos = (t.contiguous()
                               for t in (dc, rest, means, campos))
    n, rows = means.shape[0], rest.shape[1]
    ck.check(dc, "features_dc", torch.float32, (n, 1, 3), dev)
    ck.check(rest, "features_rest", torch.float32, (n, rows, 3), dev)
    ck.check(means, "means", torch.float32, (n, 3), dev)
    ck.check(campos, "campos", torch.float32, (3,), dev)
    return dc, rest, means, campos, n, rows


def sh_fwd(deg: int, dc, rest, means, campos) -> torch.Tensor:
    """The clamped colour [N, 3] of CUDA tensors: one `sh_fwd` launch."""
    dc, rest, means, campos, n, rows = _inputs(dc, rest, means, campos)
    rgb = torch.empty((n, 3), dtype=torch.float32, device=means.device)
    ck.launch("sh_fwd", means.device, dc.data_ptr(),
              rest.data_ptr(), means.data_ptr(), campos.data_ptr(), n, deg,
              rows, rgb.data_ptr())
    return rgb


def sh_bwd(deg: int, g, dc, rest, means, campos, needs: Sequence[bool]
           ) -> Tuple[Optional[torch.Tensor], ...]:
    """`_sh_bwd_plain`'s (g_dc, g_rest, g_means) for CUDA tensors from the
    inputs alone: one `sh_bwd` launch. g [N, 3] is read through its
    strides, as the compositing table's gradient hands it over."""
    dc, rest, means, campos, n, rows = _inputs(dc, rest, means, campos)
    dev = means.device
    if g.dtype != torch.float32 or g.device != dev or g.shape != (n, 3):
        raise ValueError(f"g: {g.dtype} {tuple(g.shape)} on {g.device}, "
                         f"expected float32 ({n}, 3) on {dev}")
    want = (needs[0], needs[1], needs[2] and deg > 0)
    out = [torch.empty_like(t) if w else None
           for t, w in zip((dc, rest, means), want)]
    if any(want):
        ck.launch("sh_bwd", dev, g.data_ptr(), g.stride(0),
                  g.stride(1), dc.data_ptr(), rest.data_ptr(),
                  means.data_ptr(), campos.data_ptr(), n, deg, rows,
                  *(0 if t is None else t.data_ptr() for t in out))
    return tuple(out)


class _SHColour(torch.autograd.Function):
    """Clamped RGB of N Gaussians from features_dc [N, 1, 3] and
    features_rest [N, K-1, 3] at the active degree deg, seen from campos:
    coefficients past (deg+1)^2 take no part and get a zero gradient, and
    campos gets none. The kernels on CUDA tensors, the plain twin on CPU
    tensors."""

    @staticmethod
    def forward(ctx, deg, dc, rest, means, campos):
        ctx.deg = deg
        with timing.span("sh"):
            if means.is_cuda:
                ctx.save_for_backward(dc, rest, means, campos)
                return sh_fwd(deg, dc, rest, means, campos)
            rgb, saved = _sh_fwd_plain(deg, dc, rest, means, campos)
            ctx.save_for_backward(*saved)
            return rgb

    @staticmethod
    @timing.spanned("sh_bwd")
    def backward(ctx, g):
        needs = ctx.needs_input_grad[1:4]
        if g.is_cuda:
            grads = sh_bwd(ctx.deg, g, *ctx.saved_tensors, needs)
        else:
            grads = _sh_bwd_plain(ctx.deg, g, ctx.saved_tensors, needs)
        return (None, *grads, None)


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
