"""Real spherical harmonics up to degree 3 (port of gi_gs_tpu/ops/sh.py;
ref computeColorFromSH, cuda_rasterizer/forward.cu:22-80)."""
from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


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


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """sh [..., K, 3] (K >= (deg+1)^2), dirs [..., 3] -> raw SH value."""
    basis = sh_basis(deg, dirs)
    B = basis.shape[-1]
    return torch.einsum("...k,...kc->...c", basis, sh[..., :B, :])


def sh_to_rgb(deg: int, sh: torch.Tensor, means: torch.Tensor,
              campos: torch.Tensor) -> torch.Tensor:
    """Per-Gaussian clamped RGB as the rasterizer preprocess computes it:
    dir = normalize(mean - campos), +0.5 offset, clamp at 0."""
    d = means - campos
    n2 = (d * d).sum(-1, keepdim=True)
    d = d * torch.rsqrt(torch.maximum(n2, torch.full_like(n2, 1e-24)))
    rgb = eval_sh(deg, sh, d) + 0.5
    return torch.maximum(rgb, rgb.new_zeros(()))


def rgb_to_sh0(rgb: torch.Tensor) -> torch.Tensor:
    """Inverse of the DC term mapping (utils/sh_utils.py RGB2SH)."""
    return (rgb - 0.5) / SH_C0
