"""Deferred split-sum PBR shading, channels first (port of
gi_gs_tpu/ops/shading.py `pbr_shading_chw` and its LUT / trilinear
specular helpers; ref pbr/shade.py pbr_shading). The environment-BRDF LUT
is generated (Karis 2013 split sum, height-correlated Smith GGX) at first
use and cached as numpy."""
from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch

from ..models import light as light_mod
from ..utils.device import device_constant
from ..utils.math_utils import aces_film, clip, linear_to_srgb
from . import cubemap as cm


def _hammersley(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.uint32)
    bits = i.copy()
    bits = (bits << np.uint32(16)) | (bits >> np.uint32(16))
    bits = ((bits & np.uint32(0x55555555)) << np.uint32(1)) | \
           ((bits & np.uint32(0xAAAAAAAA)) >> np.uint32(1))
    bits = ((bits & np.uint32(0x33333333)) << np.uint32(2)) | \
           ((bits & np.uint32(0xCCCCCCCC)) >> np.uint32(2))
    bits = ((bits & np.uint32(0x0F0F0F0F)) << np.uint32(4)) | \
           ((bits & np.uint32(0xF0F0F0F0)) >> np.uint32(4))
    bits = ((bits & np.uint32(0x00FF00FF)) << np.uint32(8)) | \
           ((bits & np.uint32(0xFF00FF00)) >> np.uint32(8))
    return np.stack([i / n, bits * 2.3283064365386963e-10], axis=-1)


@functools.lru_cache(maxsize=2)
def _brdf_lut_np(res: int = 256, samples: int = 4096) -> np.ndarray:
    """[res, res, 2] split-sum env-BRDF: rows = roughness, cols = NoV;
    GGX importance-sampled integration over `samples` Hammersley points."""
    xi = _hammersley(samples)
    nov = (np.arange(res) + 0.5) / res
    rough = (np.arange(res) + 0.5) / res
    out = np.zeros((res, res, 2), np.float32)
    for yi, r in enumerate(rough):
        a = r * r
        a2 = a * a
        phi = 2.0 * np.pi * xi[:, 0]
        cos_t = np.sqrt((1.0 - xi[:, 1]) / (1.0 + (a2 - 1.0) * xi[:, 1]))
        sin_t = np.sqrt(np.maximum(1.0 - cos_t ** 2, 0.0))
        hx = np.cos(phi) * sin_t
        hz = cos_t
        v = np.stack([np.sqrt(1.0 - nov ** 2), np.zeros_like(nov), nov], -1)
        vdh = (v[:, None, 0] * hx[None] + v[:, None, 2] * hz[None])
        lz = 2.0 * vdh * hz[None] - v[:, None, 2]
        valid = lz > 0
        nol = np.clip(lz, 0.0, 1.0)
        noh = np.clip(hz[None], 0.0, 1.0)
        voh = np.clip(vdh, 0.0, 1.0)
        NoV = nov[:, None]
        lam_v = NoV * np.sqrt(nol ** 2 * (1.0 - a2) + a2)
        lam_l = nol * np.sqrt(NoV ** 2 * (1.0 - a2) + a2)
        vis = 0.5 / np.maximum(lam_v + lam_l, 1e-8)
        g_vis = np.where(valid & (noh > 0),
                         4.0 * vis * voh * nol / np.maximum(noh, 1e-8), 0.0)
        fc = (1.0 - voh) ** 5
        out[yi, :, 0] = ((1.0 - fc) * g_vis).sum(1) / samples
        out[yi, :, 1] = (fc * g_vis).sum(1) / samples
    return out


def sample_brdf_lut(lut: torch.Tensor, nov: torch.Tensor,
                    roughness: torch.Tensor) -> torch.Tensor:
    """Bilinear clamp lookup: lut [R, R, 2], nov/roughness [..., 1]
    -> [..., 2] (dr.texture clamp boundary)."""
    R = lut.shape[0]
    u = torch.clamp(nov[..., 0] * R - 0.5, 0.0, R - 1)
    v = torch.clamp(roughness[..., 0] * R - 0.5, 0.0, R - 1)
    u0, v0 = torch.floor(u), torch.floor(v)
    u1 = torch.clamp(u0 + 1, max=R - 1)
    v1 = torch.clamp(v0 + 1, max=R - 1)
    du = (u - u0)[..., None]
    dv = (v - v0)[..., None]
    flat = lut.reshape(-1, 2)
    f = lambda vv, uu: flat[(vv * R + uu).to(torch.int64)]
    return (f(v0, u0) * (1 - du) * (1 - dv) + f(v0, u1) * du * (1 - dv) +
            f(v1, u0) * (1 - du) * dv + f(v1, u1) * du * dv)


# Axis permutation between the rasterizer and cubemap frames
# (pbr/shade.py:134-138).
_TRANSFORM = ((0.0, -1.0, 0.0), (0.0, 0.0, 1.0), (-1.0, 0.0, 0.0))


def _frame_rows(T, x, y, z):
    return (T[0][0] * x + T[0][1] * y + T[0][2] * z,
            T[1][0] * x + T[1][1] * y + T[1][2] * z,
            T[2][0] * x + T[2][1] * y + T[2][2] * z)


@functools.lru_cache(maxsize=2)
def _brdf_lut_quad(res: int = 256, samples: int = 4096) -> np.ndarray:
    """[res*res, 8] edge-clamped quad table of the LUT: row (v0, u0)
    holds t00.xy | t01.xy | t10.xy | t11.xy."""
    lut = _brdf_lut_np(res, samples)
    p = np.pad(lut, ((0, 1), (0, 1), (0, 0)), mode="edge")
    q = np.concatenate([p[:-1, :-1], p[:-1, 1:], p[1:, :-1], p[1:, 1:]],
                       axis=-1)
    return q.reshape(-1, 8)


def _sample_brdf_lut_flat(nov, roughness, res: int = 256):
    """Flat bilinear LUT lookup: nov/roughness [P] -> (fg0, fg1) [P]."""
    quad = device_constant(_brdf_lut_quad, res, device=nov.device)
    u = clip(nov * res - 0.5, 0.0, res - 1)
    v = clip(roughness * res - 0.5, 0.0, res - 1)
    u0, v0 = torch.floor(u), torch.floor(v)
    du, dv = u - u0, v - v0
    Q = cm.take_rows(quad, v0.to(torch.int64) * res + u0.to(torch.int64))
    w00 = (1 - du) * (1 - dv)
    w01 = du * (1 - dv)
    w10 = (1 - du) * dv
    w11 = du * dv
    return tuple(Q[:, c] * w00 + Q[:, 2 + c] * w01 + Q[:, 4 + c] * w10 +
                 Q[:, 6 + c] * w11 for c in range(2))


def _level_rows(ress) -> np.ndarray:
    """[2, L] int64: each level's resolution and its first row in the
    concatenated quad table of `_trilinear_specular_flat`."""
    ress = np.array(ress, np.int64)
    offs = np.cumsum(6 * (ress + 1) * (ress + 1)) - 6 * (ress + 1) ** 2
    return np.stack([ress, offs])


def _trilinear_specular_flat(specular, dx, dy, dz, mip):
    """Per-pixel fractional-mip lookup over the prefiltered stack
    (dr.texture linear-mipmap-linear): each pixel gathers one quad row
    from each of its two adjacent levels (`take_rows`, whose backward is
    one `index_add_` into the concatenated quad tables)."""
    L = len(specular)
    quads = [cm.quad_pack(cm.pad_cubemap(s)) for s in specular]
    flatq = torch.cat(quads, dim=0)
    ress_t, offs_t = device_constant(
        _level_rows, tuple(s.shape[1] for s in specular), device=dx.device)

    mip = clip(mip, 0.0, L - 1)
    lo = torch.floor(mip)
    frac = mip - lo
    lo_i = lo.to(torch.int64)
    hi_i = torch.clamp(lo_i + 1, max=L - 1)
    face, fx, fy = cm.dir_to_face_uv_flat(dx, dy, dz)

    def sample_level(lvl):
        R = ress_t[lvl]
        Rf = R.to(torch.float32)
        E1 = R + 1
        u = (fx + 1.0) * 0.5 * Rf - 0.5
        v = (fy + 1.0) * 0.5 * Rf - 0.5
        u0 = torch.minimum(torch.clamp(torch.floor(u), min=-1), Rf - 1)
        v0 = torch.minimum(torch.clamp(torch.floor(v), min=-1), Rf - 1)
        du = clip(u - u0, 0.0, 1.0)
        dv = clip(v - v0, 0.0, 1.0)
        idx = offs_t[lvl] + face * E1 * E1 + \
            (v0.to(torch.int64) + 1) * E1 + (u0.to(torch.int64) + 1)
        Q = cm.take_rows(flatq, idx)
        w00 = (1 - du) * (1 - dv)
        w01 = du * (1 - dv)
        w10 = (1 - du) * dv
        w11 = du * dv
        return tuple(Q[:, c] * w00 + Q[:, 3 + c] * w01 +
                     Q[:, 6 + c] * w10 + Q[:, 9 + c] * w11
                     for c in range(3))

    slo = sample_level(lo_i)
    shi = sample_level(hi_i)
    return tuple(a * (1.0 - frac) + b * frac for a, b in zip(slo, shi))


def pbr_shading_chw(light: light_mod.CubemapLight,
                    normals: torch.Tensor,      # [3, H, W] world
                    view_dirs: torch.Tensor,    # [3, H, W]
                    albedo: torch.Tensor,       # [3, H, W]
                    roughness: torch.Tensor,    # [1, H, W]
                    mask: torch.Tensor,         # [1, H, W] bool
                    tone: bool = False,
                    gamma: bool = False,
                    occlusion: Optional[torch.Tensor] = None,  # [1, H, W]
                    metallic: Optional[torch.Tensor] = None,
                    background: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
    """Split-sum shading of channel-first G-buffer images."""
    C, H, W = normals.shape
    P = H * W
    T = _TRANSFORM
    flat = lambda img: img.reshape(img.shape[0], P)
    nx, ny, nz = flat(normals)
    vx, vy, vz = flat(view_dirs)
    ar, ag, ab = flat(albedo)
    rough = flat(roughness)[0]
    occ = None if occlusion is None else flat(occlusion)[0]

    ndv = nx * vx + ny * vy + nz * vz
    ndv_pos = 2.0 * clip(ndv, 0.0)
    rx, ry, rz = (ndv_pos * nx - vx, ndv_pos * ny - vy, ndv_pos * nz - vz)

    ncx, ncy, ncz = _frame_rows(T, nx, ny, nz)
    vcx, vcy, vcz = _frame_rows(T, vx, vy, vz)
    rcx, rcy, rcz = _frame_rows(T, rx, ry, rz)

    dr, dg, db = cm.sample_cubemap_flat(light.diffuse, ncx, ncy, ncz)
    if occ is not None:
        dr, dg, db = dr * occ, dg * occ, db * occ
    diff_r, diff_g, diff_b = dr * ar, dg * ag, db * ab

    nov = clip(ncx * vcx + ncy * vcy + ncz * vcz, 1e-4, 1.0)
    fg0, fg1 = _sample_brdf_lut_flat(nov, rough)

    miplevel = light_mod.get_mip(rough, len(light.specular))
    sr, sg, sb = _trilinear_specular_flat(light.specular, rcx, rcy, rcz,
                                          miplevel)
    if metallic is None:
        f0r = f0g = f0b = torch.full((P,), 0.04, dtype=torch.float32,
                                     device=normals.device)
    else:
        m = flat(metallic)[0]
        f0r = (1.0 - m) * 0.04 + ar * m
        f0g = (1.0 - m) * 0.04 + ag * m
        f0b = (1.0 - m) * 0.04 + ab * m
    spec_r = sr * (f0r * fg0 + fg1)
    spec_g = sg * (f0g * fg0 + fg1)
    spec_b = sb * (f0b * fg0 + fg1)

    def assemble(r, g, b):
        return torch.stack([r, g, b], dim=0).reshape(3, H, W)

    diffuse_rgb = assemble(diff_r, diff_g, diff_b)
    specular_rgb = assemble(spec_r, spec_g, spec_b)
    diffuse_light = assemble(dr, dg, db)
    render_rgb = diffuse_rgb + specular_rgb
    if tone:
        render_rgb = aces_film(render_rgb)
    else:
        render_rgb = clip(render_rgb, 0.0, 1.0)
    if gamma:
        render_rgb = linear_to_srgb(render_rgb)
        diffuse_rgb = linear_to_srgb(diffuse_rgb)
        specular_rgb = linear_to_srgb(specular_rgb)
    if background is None:
        background = torch.zeros_like(render_rgb)
    render_rgb = torch.where(mask, render_rgb, background)
    return {"render_rgb": render_rgb, "diffuse_rgb": diffuse_rgb,
            "specular_rgb": specular_rgb, "diffuse_light": diffuse_light}
