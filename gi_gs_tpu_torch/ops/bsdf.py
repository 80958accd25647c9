"""Point-light BSDF primitives, shading-normal preparation, transforms
and HDR image losses (port of gi_gs_tpu/ops/bsdf.py; the nvdiffrec
renderutils op set, pbr/renderutils/{ops.py, bsdf.py, loss.py}).

Nothing in the training or serving paths uses them (GI-GS shades with the
split-sum cubemap prefilter); they complete the renderutils surface. All
are plain differentiable torch ops, tensors [..., 3] channel-last. Every
clip is `math_utils.clip` (a tie splits the gradient, as jnp.clip).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..utils.math_utils import clip

NORMAL_THRESHOLD = 0.1
SPECULAR_EPSILON = 1e-4


def _dot(x, y):
    return (x * y).sum(-1, keepdim=True)


def reflect(x, n):
    return 2.0 * _dot(x, n) * n - x


def safe_normalize(x, eps: float = 1e-20):
    n2 = (x * x).sum(-1, keepdim=True)
    return x * torch.rsqrt(clip(n2, eps))


# ---------------------------------------------------------------------------
# Shading normal preparation (bsdf.py:29-53)
# ---------------------------------------------------------------------------

def _bend_normal(view_vec, smooth_nrm, geom_nrm, two_sided_shading):
    if two_sided_shading:
        facing = _dot(geom_nrm, view_vec) > 0
        smooth_nrm = torch.where(facing, smooth_nrm, -smooth_nrm)
        geom_nrm = torch.where(facing, geom_nrm, -geom_nrm)
    t = clip(_dot(view_vec, smooth_nrm) / NORMAL_THRESHOLD, 0.0, 1.0)
    return geom_nrm + t * (smooth_nrm - geom_nrm)


def _perturb_normal(perturbed_nrm, smooth_nrm, smooth_tng, opengl):
    smooth_bitang = safe_normalize(torch.cross(smooth_tng, smooth_nrm,
                                               dim=-1))
    sign = -1.0 if opengl else 1.0
    shading = (smooth_tng * perturbed_nrm[..., 0:1]
               + sign * smooth_bitang * perturbed_nrm[..., 1:2]
               + smooth_nrm * clip(perturbed_nrm[..., 2:3], 0.0))
    return safe_normalize(shading)


def prepare_shading_normal(pos, view_pos, perturbed_nrm: Optional[
        torch.Tensor], smooth_nrm, smooth_tng, geom_nrm,
        two_sided_shading: bool = True, opengl: bool = True):
    """Final shading normal: tangent-space perturbation, two-sided flip
    and backface bending (ref ops.py prepare_shading_normal:181-227)."""
    if perturbed_nrm is None:
        perturbed_nrm = smooth_nrm.new_tensor([0.0, 0.0, 1.0])
    smooth_nrm = safe_normalize(smooth_nrm)
    smooth_tng = safe_normalize(smooth_tng)
    view_vec = safe_normalize(view_pos - pos)
    shading_nrm = _perturb_normal(perturbed_nrm.expand(smooth_nrm.shape),
                                  smooth_nrm, smooth_tng, opengl)
    return _bend_normal(view_vec, shading_nrm, geom_nrm, two_sided_shading)


# ---------------------------------------------------------------------------
# BSDF lobes (bsdf.py:56-160)
# ---------------------------------------------------------------------------

def lambert(nrm, wi):
    """clamp(N.wi)/pi (ref bsdf_lambert)."""
    return clip(_dot(nrm, wi), 0.0) / math.pi


def fresnel_schlick(f0, f90, cos_theta):
    c = clip(cos_theta, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)
    return f0 + (f90 - f0) * (1.0 - c) ** 5.0


def ndf_ggx(alpha_sqr, cos_theta):
    c = clip(cos_theta, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)
    d = (c * alpha_sqr - c) * c + 1.0
    return alpha_sqr / (d * d * math.pi)


def lambda_ggx(alpha_sqr, cos_theta):
    c = clip(cos_theta, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)
    c2 = c * c
    tan2 = (1.0 - c2) / c2
    return 0.5 * (torch.sqrt(1.0 + alpha_sqr * tan2) - 1.0)


def masking_smith_ggx_correlated(alpha_sqr, cos_theta_i, cos_theta_o):
    return 1.0 / (1.0 + lambda_ggx(alpha_sqr, cos_theta_i) +
                  lambda_ggx(alpha_sqr, cos_theta_o))


def frostbite_diffuse(nrm, wi, wo, linear_roughness):
    """Frostbite normalized Disney diffuse (ref bsdf_frostbite)."""
    wi_dot_n = _dot(wi, nrm)
    wo_dot_n = _dot(wo, nrm)
    h = safe_normalize(wo + wi)
    wi_dot_h = _dot(wi, h)
    energy_bias = 0.5 * linear_roughness
    energy_factor = 1.0 - (0.51 / 1.51) * linear_roughness
    f90 = energy_bias + 2.0 * wi_dot_h * wi_dot_h * linear_roughness
    res = fresnel_schlick(1.0, f90, wi_dot_n) * \
        fresnel_schlick(1.0, f90, wo_dot_n) * energy_factor
    return torch.where((wi_dot_n > 0.0) & (wo_dot_n > 0.0), res,
                       torch.zeros_like(res))


def phong(nrm, wo, wi, n_exp):
    dp_r = clip(_dot(reflect(wo, nrm), wi), 0.0, 1.0)
    dp_l = clip(_dot(nrm, wi), 0.0, 1.0)
    return (dp_r ** n_exp) * dp_l * (n_exp + 2) / (2 * math.pi)


def pbr_specular(col, nrm, wo, wi, alpha, min_roughness: float = 0.08):
    """GGX specular lobe (ref bsdf_pbr_specular)."""
    a = clip(alpha, min_roughness * min_roughness, 1.0)
    alpha_sqr = a * a
    h = safe_normalize(wo + wi)
    wo_dot_n = _dot(wo, nrm)
    wi_dot_n = _dot(wi, nrm)
    wo_dot_h = _dot(wo, h)
    n_dot_h = _dot(nrm, h)
    D = ndf_ggx(alpha_sqr, n_dot_h)
    G = masking_smith_ggx_correlated(alpha_sqr, wo_dot_n, wi_dot_n)
    F = fresnel_schlick(col, 1.0, wo_dot_h)
    w = F * D * G * 0.25 / clip(wo_dot_n, SPECULAR_EPSILON)
    frontfacing = (wo_dot_n > SPECULAR_EPSILON) & (wi_dot_n > SPECULAR_EPSILON)
    return torch.where(frontfacing, w, torch.zeros_like(w))


def pbr_bsdf(kd, arm, pos, nrm, view_pos, light_pos,
             min_roughness: float = 0.08, bsdf: str = "lambert"):
    """Full point-light BSDF: diffuse + specular (ref bsdf_pbr)."""
    wo = safe_normalize(view_pos - pos)
    wi = safe_normalize(light_pos - pos)
    spec_str = arm[..., 0:1]
    roughness = arm[..., 1:2]
    metallic = arm[..., 2:3]
    ks = (0.04 * (1.0 - metallic) + kd * metallic) * (1.0 - spec_str)
    kd_eff = kd * (1.0 - metallic)
    if bsdf == "frostbite":
        diffuse = kd_eff * frostbite_diffuse(nrm, wi, wo, roughness)
    else:
        diffuse = kd_eff * lambert(nrm, wi)
    specular = pbr_specular(ks, nrm, wo, wi, roughness * roughness,
                            min_roughness=min_roughness)
    return diffuse + specular


# ---------------------------------------------------------------------------
# Transforms (ref ops.py xfm_points/xfm_vectors, c_src/mesh.cu)
# ---------------------------------------------------------------------------

def xfm_points(points, matrix):
    """[B, N, 3] x [B, 4, 4] -> homogeneous [B, N, 4]."""
    ones = torch.ones(points.shape[:-1] + (1,), dtype=points.dtype,
                      device=points.device)
    hom = torch.cat([points, ones], dim=-1)
    return torch.einsum("bnk,bjk->bnj", hom, matrix)


def xfm_vectors(vectors, matrix):
    """[B, N, 3] x [B, 4, 4] -> rotated [B, N, 3] (w = 0)."""
    return torch.einsum("bnk,bjk->bnj", vectors, matrix[..., :3, :3])


# ---------------------------------------------------------------------------
# HDR image losses (ref loss.py, c_src/loss.cu fused tonemap+loss)
# ---------------------------------------------------------------------------

def _tonemap_srgb(f):
    return torch.where(f > 0.0031308,
                       torch.pow(clip(f, 0.0031308), 1.0 / 2.4) * 1.055
                       - 0.055, 12.92 * f)


def image_loss(img, target, loss: str = "l1", tonemapper: str = "none"):
    """Fused tonemap + loss (ref image_loss_fn)."""
    if tonemapper == "log_srgb":
        img = _tonemap_srgb(torch.log(clip(img, 0.0, 65535.0) + 1.0))
        target = _tonemap_srgb(torch.log(clip(target, 0.0, 65535.0) + 1.0))
    if loss == "mse":
        return ((img - target) ** 2).mean()
    if loss == "smape":
        return ((img - target).abs() /
                (img.abs() + target.abs() + 0.01)).mean()
    if loss == "relmse":
        return (((img - target) ** 2) /
                (img * img + target * target + 0.1)).mean()
    return (img - target).abs().mean()
