"""Cubemap sampling and diffuse/GGX prefiltering (port of
gi_gs_tpu/ops/cubemap.py; ref nvdiffrast cube lookups and
renderutils/c_src/cubemap.cu).

The prefilter is linear in the texels with static weights. Levels up to
32^2 (and the diffuse irradiance) are one dense [S, S] f32 matrix product;
higher levels are a locally connected halo filter
out[f, c, y, x] = sum_p W[f, p, y, x] * pad[f, c, y + dy, x + dx]
over halo-padded faces (`_patch_tables`). That filter is an autograd
Function over the level's cubemap (`_PatchFilter`, JAX's custom VJP
`_specular_apply_patch`): its forward gathers the halo and runs the CUDA
kernel `csrc/patch_fwd.cu` (`patch_fwd`) on CUDA tensors or
`_patch_fwd_plain` on CPU tensors; its backward runs the transpose
`csrc/patch_bwd.cu` (`patch_bwd`) or `_patch_bwd_plain`, keeps the core
and adds the halo ring back with one segment sum over the static border
positions (JAX's `_sap_bwd`); W is a constant table. `cubemap_mip` is a
Function too, with JAX's backward `_mip_bwd`.

Every differentiable texture gather goes through `take_rows` (JAX's
`take_rows` / `take_rows3`), whose backward is one `index_add_` of the
cotangent rows, so no autograd index backward (a sort of the indices and
a serial sum per run of equal ones) is left on the light's path.

The numpy table builders are cached per (resolution, roughness); the
prefilter tables are copied to the device once per light build, the small
per-view index maps once per process (`device_constant`).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..utils import timing
from ..utils.device import device_constant
from ..utils.math_utils import clip
from . import cuda_kernels as ck


# ---------------------------------------------------------------------------
# Geometry helpers (cubemap.cu:17-60 conventions)
# ---------------------------------------------------------------------------

def _face_dirs(idx: np.ndarray) -> np.ndarray:
    """[6, n, n, 3] unnormalised directions of face-local coordinates."""
    fy, fx = np.meshgrid(idx, idx, indexing="ij")
    one = np.ones_like(fx)
    return np.stack([
        np.stack([one, -fy, -fx], -1), np.stack([-one, -fy, fx], -1),
        np.stack([fx, one, fy], -1), np.stack([fx, -one, -fy], -1),
        np.stack([fx, -fy, one], -1), np.stack([-fx, -fy, -one], -1)], 0)


def texel_dirs(res: int) -> np.ndarray:
    """[6, R, R, 3] unit directions at texel centres (cubemap.cu:32-46)."""
    d = _face_dirs((np.arange(res) + 0.5) / res * 2.0 - 1.0)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def texel_areas(res: int) -> np.ndarray:
    """[R, R] solid angles (pixel_area, cubemap.cu:17-30)."""
    if res == 1:
        return np.ones((1, 1), np.float32)
    H = res // 2
    x = np.abs(np.arange(res) - H)
    dx = np.arctan((x + 1) / H) - np.arctan(x / H)
    return (dx[None, :] * dx[:, None]).astype(np.float32)


def _dir_to_face_uv_np(dirs: np.ndarray):
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ax, ay, az = np.abs(x), np.abs(y), np.abs(z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = np.where(is_x, np.where(x >= 0, 0, 1),
                    np.where(is_y, np.where(y >= 0, 2, 3),
                             np.where(z >= 0, 4, 5)))
    major = np.maximum(np.where(is_x, ax, np.where(is_y, ay, az)), 1e-20)
    fx = np.where(is_x, np.where(x >= 0, -z, z),
                  np.where(is_y, x, np.where(z >= 0, x, -x))) / major
    fy = np.where(is_x, -y, np.where(is_y, np.where(y >= 0, z, -z), -y)) / major
    return face, fx, fy


def dir_to_face_uv_flat(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor):
    """Component-wise dir -> (face, fx, fy in [-1, 1])."""
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    w = torch.where
    face = w(is_x, w(x >= 0, 0, 1),
             w(is_y, w(y >= 0, 2, 3), w(z >= 0, 4, 5)))
    major = torch.clamp(w(is_x, ax, w(is_y, ay, az)), min=1e-20)
    fx = w(is_x, w(x >= 0, -z, z), w(is_y, x, w(z >= 0, x, -x))) / major
    fy = w(is_x, -y, w(is_y, w(y >= 0, z, -z), -y)) / major
    return face, fx, fy


def _halo_index_map(res: int, h: int) -> np.ndarray:
    """[6, R+2h, R+2h] int32: extended face positions (h-texel halo)
    resolved to the nearest true texel across the cube edge; the
    interior maps to itself."""
    ext = _face_dirs((np.arange(-h, res + h) + 0.5) / res * 2.0 - 1.0)
    ext = ext / np.linalg.norm(ext, axis=-1, keepdims=True)
    fc, fxx, fyy = _dir_to_face_uv_np(ext)
    uu = np.clip(((fxx + 1) * 0.5 * res - 0.5).round(), 0, res - 1)
    vv = np.clip(((fyy + 1) * 0.5 * res - 0.5).round(), 0, res - 1)
    return (fc * res * res + vv * res + uu).astype(np.int32)


class _TakeRows(torch.autograd.Function):
    """flat [T, C] gathered at idx [...] -> [..., C] (JAX's `take_rows` /
    `take_rows3`, cubemap.py:69-117). The backward scatter-adds the
    cotangent rows into a zero [T, C] with one `index_add_` (JAX adds one
    column at a time only because TPU row-update scatters were slow); the
    sums are the same, in another order."""

    @staticmethod
    def forward(ctx, flat, idx):
        ctx.save_for_backward(idx)
        ctx.rows = flat.shape[0]
        return flat.index_select(0, idx.reshape(-1)).reshape(
            *idx.shape, flat.shape[1])

    @staticmethod
    @timing.spanned("light_bwd")
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        C = g.shape[-1]
        out = g.new_zeros((ctx.rows, C)).index_add_(
            0, idx.reshape(-1), g.reshape(-1, C))
        return out, None


def take_rows(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat [T, C] gathered at the int64 row ids idx [...] -> [..., C],
    with the scatter-add backward of `_TakeRows`."""
    return _TakeRows.apply(flat, idx)


@functools.lru_cache(maxsize=8)
def _edge_index_map(res: int) -> np.ndarray:
    """The 1-texel halo map, int64 for indexing."""
    return _halo_index_map(res, 1).astype(np.int64)


@functools.lru_cache(maxsize=8)
def _edge_strips(res: int) -> np.ndarray:
    """int64 source texels of the four halo strips of `pad_cubemap`, one
    after the other: top [6, 1, R+2], bottom [6, 1, R+2], left [6, R, 1],
    right [6, R, 1]."""
    emap, R = _edge_index_map(res), res
    return np.concatenate([emap[:, 0:1, :].ravel(), emap[:, R + 1:, :].ravel(),
                           emap[:, 1:R + 1, 0:1].ravel(),
                           emap[:, 1:R + 1, R + 1:].ravel()])


def pad_cubemap(cubemap: torch.Tensor) -> torch.Tensor:
    """[6, R, R, C] -> [6, R+2, R+2, C] with a 1-texel cross-face halo
    (nvdiffrast boundary_mode="cube" emulation). The halo map is the
    identity inside each face, so only the four border strips are gathered
    (JAX cubemap.py:170-185; here in one `take_rows`) and concatenated
    around the face."""
    R, C = cubemap.shape[1], cubemap.shape[-1]
    E = R + 2
    flat = cubemap.reshape(-1, C)
    strips = take_rows(flat, device_constant(_edge_strips, R,
                                             device=cubemap.device))
    top, bot, left, right = strips.split([6 * E, 6 * E, 6 * R, 6 * R])
    mid = torch.cat([left.reshape(6, R, 1, C), cubemap,
                     right.reshape(6, R, 1, C)], dim=2)
    return torch.cat([top.reshape(6, 1, E, C), mid,
                      bot.reshape(6, 1, E, C)], dim=1)


def quad_pack(padded: torch.Tensor) -> torch.Tensor:
    """[6, E, E, C] halo-padded faces -> [6*(E-1)*(E-1), 4C]: row
    (f, v0, u0) holds the 2x2 bilinear footprint t00 | t01 | t10 | t11."""
    q = torch.cat([padded[:, :-1, :-1], padded[:, :-1, 1:],
                   padded[:, 1:, :-1], padded[:, 1:, 1:]], dim=-1)
    return q.reshape(-1, q.shape[-1])


def sample_cubemap_flat(cubemap: torch.Tensor, dx, dy, dz):
    """Seamless bilinear lookup: cubemap [6, R, R, 3], direction rows [P]
    -> (r, g, b) [P]."""
    R = cubemap.shape[1]
    quad = quad_pack(pad_cubemap(cubemap))
    face, fx, fy = dir_to_face_uv_flat(dx, dy, dz)
    u = (fx + 1.0) * 0.5 * R - 0.5
    v = (fy + 1.0) * 0.5 * R - 0.5
    u0 = torch.clamp(torch.floor(u), -1, R - 1)
    v0 = torch.clamp(torch.floor(v), -1, R - 1)
    du = clip(u - u0, 0.0, 1.0)
    dv = clip(v - v0, 0.0, 1.0)
    E1 = R + 1
    idx = (face * E1 * E1 + (v0.to(torch.int64) + 1) * E1 +
           (u0.to(torch.int64) + 1))
    Q = take_rows(quad, idx)                        # [P, 12]
    w00 = (1 - du) * (1 - dv)
    w01 = du * (1 - dv)
    w10 = (1 - du) * dv
    w11 = du * dv
    return tuple(Q[:, c] * w00 + Q[:, 3 + c] * w01 + Q[:, 6 + c] * w10 +
                 Q[:, 9 + c] * w11 for c in range(3))


def sample_cubemap(cubemap: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Seamless bilinear lookup: cubemap [6, R, R, 3], dirs [..., 3]."""
    flat = dirs.reshape(-1, 3)
    r, g, b = sample_cubemap_flat(cubemap, flat[:, 0], flat[:, 1],
                                  flat[:, 2])
    return torch.stack([r, g, b], dim=-1).reshape(dirs.shape)


def _texel_dirs_f32(res: int) -> np.ndarray:
    return texel_dirs(res).astype(np.float32)


class _CubemapMip(torch.autograd.Function):
    """2x2 average pool per face whose backward is the reference's bilinear
    redistribution (pbr/light.py:62-79; JAX cubemap.py:295-319): the
    seamless bilinear sample of 0.25 * dout at the fine texel directions,
    not the pool's transpose."""

    @staticmethod
    def forward(ctx, cubemap):
        R = cubemap.shape[1]
        c = cubemap.reshape(6, R // 2, 2, R // 2, 2, cubemap.shape[-1])
        return 0.25 * (c[:, :, 0, :, 0] + c[:, :, 0, :, 1] +
                       c[:, :, 1, :, 0] + c[:, :, 1, :, 1])

    @staticmethod
    @timing.spanned("light_bwd")
    def backward(ctx, dout):
        R = 2 * dout.shape[1]
        dirs = device_constant(_texel_dirs_f32, R, device=dout.device)
        return sample_cubemap(dout * 0.25, dirs)


def cubemap_mip(cubemap: torch.Tensor) -> torch.Tensor:
    """2x2 average pool per face (pbr/light.py:54-79), with the reference's
    backward (`_CubemapMip`)."""
    return _CubemapMip.apply(cubemap)


# ---------------------------------------------------------------------------
# Prefilter weights (static, cached per (res, roughness))
# ---------------------------------------------------------------------------

def _ndf_ggx_np(alpha_sqr, cos_theta):
    c = np.clip(cos_theta, 0.0, 1.0)
    d = (c * alpha_sqr - c) * c + 1.0
    return alpha_sqr / (d * d * np.pi)


@functools.lru_cache(maxsize=32)
def ndf_cutoff(roughness: float, cutoff: float = 0.99) -> float:
    """cos(theta) bound retaining `cutoff` of the NDF (__ndfBounds,
    renderutils/ops.py:428-443, with its un-sin-weighted cumulative)."""
    n = 1000000
    cos_t = np.cos(np.linspace(0, np.pi / 2.0, n))
    D = np.cumsum(_ndf_ggx_np(roughness ** 4, cos_t))
    idx = int(np.argmax(D >= D[-1] * cutoff))
    return float(cos_t[idx])


@functools.lru_cache(maxsize=8)
def diffuse_matrix(res: int) -> np.ndarray:
    """[S, S] cosine operator (DiffuseCubemapFwdKernel, cubemap.cu:110-139)."""
    dirs = texel_dirs(res).reshape(-1, 3)
    areas = np.tile(texel_areas(res)[None], (6, 1, 1)).reshape(-1)
    cos = np.clip(dirs @ dirs.T, 0.0, 0.999)
    return (cos * (areas[None, :] / np.pi)).astype(np.float32)


@functools.lru_cache(maxsize=16)
def specular_matrix(res: int, roughness: float, cutoff: float = 0.99
                    ) -> np.ndarray:
    """Dense normalised GGX operator for res <= 32."""
    cos_cut = ndf_cutoff(roughness, cutoff)
    dirs = texel_dirs(res).reshape(-1, 3)
    areas = np.tile(texel_areas(res)[None], (6, 1, 1)).reshape(-1)
    dots = dirs @ dirs.T
    vnr_dot_h = np.sqrt(np.clip((1.0 + dots) * 0.5, 0.0, 1.0))
    w = np.clip(dots, 0.0, None) * _ndf_ggx_np(roughness ** 4, vnr_dot_h) * \
        (areas[None, :] / 4.0)
    w = np.where(dots >= cos_cut, w, 0.0).astype(np.float32)
    wsum = np.maximum(w.sum(axis=1, keepdims=True), 1e-20)
    return w / wsum


@functools.lru_cache(maxsize=16)
def _patch_tables(res: int, roughness: float, cutoff: float):
    """Static tables of the halo patch filter: (halo h, source index map
    [6, (R+2h)^2] int32, weights [6, P*P, R, R] f32 normalised), P = 2h+1."""
    cos_cut = ndf_cutoff(roughness, cutoff)
    theta = math.acos(min(cos_cut, 1.0))
    h = int(math.ceil(theta / (2.0 / res) * 1.6)) + 2
    h = min(h, res // 2)
    P = 2 * h + 1
    src_idx = _halo_index_map(res, h)                 # [6, R+2h, R+2h]

    dirs_flat = texel_dirs(res).reshape(-1, 3)
    areas_flat = np.tile(texel_areas(res)[None], (6, 1, 1)).reshape(-1)
    src_dir = dirs_flat[src_idx]
    src_area = areas_flat[src_idx]
    out_dir = texel_dirs(res)
    alpha_sqr = roughness ** 4

    W = np.zeros((6, P * P, res, res), np.float32)
    for dy in range(P):
        for dx in range(P):
            sd = src_dir[:, dy:dy + res, dx:dx + res]
            sa = src_area[:, dy:dy + res, dx:dx + res]
            dots = np.einsum("frcx,frcx->frc", out_dir, sd)
            vnr_dot_h = np.sqrt(np.clip((1.0 + dots) * 0.5, 0.0, 1.0))
            w = np.clip(dots, 0.0, None) * _ndf_ggx_np(alpha_sqr, vnr_dot_h) \
                * sa / 4.0
            W[:, dy * P + dx] = np.where(dots >= cos_cut, w, 0.0)
    W /= np.maximum(W.sum(axis=1, keepdims=True), 1e-20)
    return h, src_idx.reshape(6, -1), W


# ---------------------------------------------------------------------------
# The patch filter: kernel, plain versions, halo gather
# ---------------------------------------------------------------------------

def _patch_fwd_plain(W: torch.Tensor, padded: torch.Tensor, h: int
                     ) -> torch.Tensor:
    """W [6, P^2, R, R], padded [6, 3, E, E] -> [6, 3, R, R]: the offsets
    accumulated in order p = dy * P + dx."""
    R = W.shape[-1]
    P = 2 * h + 1
    acc = torch.zeros((6, 3, R, R), dtype=torch.float32, device=W.device)
    for p in range(P * P):
        dy, dx = divmod(p, P)
        acc = acc + padded[:, :, dy:dy + R, dx:dx + R] * W[:, p][:, None]
    return acc


def _patch_bwd_plain(W: torch.Tensor, g: torch.Tensor, h: int
                     ) -> torch.Tensor:
    """The filter's transpose: W [6, P^2, R, R], g [6, 3, R, R] -> the
    cotangent of the padded faces [6, 3, R+2h, R+2h], the offsets added in
    order p = dy * P + dx."""
    R = W.shape[-1]
    P = 2 * h + 1
    E = R + 2 * h
    bar = torch.zeros((6, 3, E, E), dtype=torch.float32, device=W.device)
    for p in range(P * P):
        dy, dx = divmod(p, P)
        bar[:, :, dy:dy + R, dx:dx + R] += g * W[:, p][:, None]
    return bar


def _apply_patch_plain(cubemap: torch.Tensor, src_idx: torch.Tensor,
                       W: torch.Tensor, h: int) -> torch.Tensor:
    """Port of `_apply_patch_ref` (cubemap.py:485-504): full halo gather,
    then the offset loop. cubemap [6, R, R, 3] -> [6, R, R, 3]."""
    R = cubemap.shape[1]
    E = R + 2 * h
    padded = cubemap.reshape(-1, 3)[src_idx.reshape(-1).long()]
    padded = padded.reshape(6, E, E, 3).permute(0, 3, 1, 2)
    return _patch_fwd_plain(W, padded, h).permute(0, 2, 3, 1)


# What one of three CTAs on an H100 SM may take of its 228 KB of shared
# memory (each CTA also reserves 1 KB).
_PATCH_FWD_CTA_SMEM = 233472 // 3 - 1024
_PATCH_FWD_MAX_STAGES = 8


def patch_fwd_shape(R: int, h: int) -> dict:
    """Launch shape of `csrc/patch_fwd.cu` at one level (R, h): one CTA per
    output row of a face (grid [1, R, 6]) of R consumer threads and a
    producer warp, and a ring of `stages` stages, each row y of the P
    weight planes of one dy and a `slot` per channel for its padded row.
    The ring takes as many stages as fit three CTAs per SM (2 to 8).
    `smem` is the dynamic shared memory in bytes, as the kernel computes
    it."""
    P, E = 2 * h + 1, R + 2 * h
    slot = (E + 6) & ~3
    stage = (P * R + 3 * slot + 31) & ~31
    stages = max(2, min(_PATCH_FWD_MAX_STAGES, P,
                        _PATCH_FWD_CTA_SMEM // (4 * stage + 16)))
    return dict(stages=stages, slot=slot, stage_floats=stage,
                smem=stages * stage * 4 + 2 * stages * 8,
                threads=32 * (-(-R // 32) + 1), grid=[1, R, 6], ctas=6 * R)


def patch_fwd(W: torch.Tensor, padded: torch.Tensor, R: int, P: int,
              h: int) -> torch.Tensor:
    """Locally connected halo filter (replaces
    pallas_patch.patch_apply_fwd). W [6, P^2, R, R]; padded
    [6, 3, R+2h, R+2h] -> [6, 3, R, R]. The kernel copies W in TMA boxes
    and the padded rows in 16-byte units: R a multiple of 4 and at most
    256, both 16-byte aligned (padded is copied if it is not)."""
    if not W.is_cuda:
        return _patch_fwd_plain(W, padded, h)
    dev = W.device
    E = R + 2 * h
    if R % 4 or R > 256:
        raise ValueError(f"patch_fwd: R = {R} is not a multiple of 4 up "
                         "to 256")
    padded = padded.contiguous()
    if padded.data_ptr() % 16:
        padded = padded.clone()
    ck.check(W, "W", torch.float32, (6, P * P, R, R), dev)
    ck.check(padded, "padded", torch.float32, (6, 3, E, E), dev)
    if W.data_ptr() % 16:
        raise ValueError("patch_fwd: W is not 16-byte aligned")
    out = torch.empty((6, 3, R, R), dtype=torch.float32, device=dev)
    ck.launch("patch_fwd", dev, W.data_ptr(),
              padded.data_ptr(), out.data_ptr(), R, P, h,
              patch_fwd_shape(R, h)["stages"])
    return out


def patch_bwd(W: torch.Tensor, g: torch.Tensor, R: int, P: int,
              h: int) -> torch.Tensor:
    """Transpose of `patch_fwd` (replaces pallas_patch.patch_apply_bwd).
    W [6, P^2, R, R]; g [6, 3, R, R] -> [6, 3, R+2h, R+2h]. The kernel
    copies W and g rows in 16-byte units: R a multiple of 4, both 16-byte
    aligned (g is copied if it is not)."""
    if not W.is_cuda:
        return _patch_bwd_plain(W, g, h)
    dev = W.device
    E = R + 2 * h
    if R % 4:
        raise ValueError(f"patch_bwd: R = {R} is not a multiple of 4")
    g = g.contiguous()
    if g.data_ptr() % 16:
        g = g.clone()
    ck.check(W, "W", torch.float32, (6, P * P, R, R), dev)
    ck.check(g, "g", torch.float32, (6, 3, R, R), dev)
    if W.data_ptr() % 16:
        raise ValueError("patch_bwd: W is not 16-byte aligned")
    out = torch.empty((6, 3, E, E), dtype=torch.float32, device=dev)
    ck.launch("patch_bwd", dev, W.data_ptr(), g.data_ptr(),
              out.data_ptr(), R, P, h)
    return out


def patch_resources(kernel: str, R: int, h: int, device: torch.device
                    ) -> dict:
    """Registers, shared memory and resident blocks per SM of `kernel`
    ("patch_fwd" or "patch_bwd") at one level's halo h, and the level's
    grid of CTAs (`cuda_kernels.resources`; launches nothing)."""
    P, E = 2 * h + 1, R + 2 * h
    if kernel == "patch_bwd":     # one padded row per CTA, <= 512 columns
        res = ck.resources("gigs_patch_bwd_resources", device, R, P)
        grid = [-(-E // (32 * min(-(-E // 32), 16))), E, 6]
        return dict(res, grid=grid, ctas=grid[0] * grid[1] * grid[2])
    shape = patch_fwd_shape(R, h)  # one output row per CTA, a ring of dy
    res = ck.resources("gigs_patch_fwd_resources", device, R, P,
                       shape["stages"])
    return dict(res, stages=shape["stages"], grid=shape["grid"],
                ctas=shape["ctas"])


def halo_pad(cubemap: torch.Tensor, src_idx: torch.Tensor, h: int
             ) -> torch.Tensor:
    """[6, R, R, 3] -> the halo-padded faces [6, 3, R+2h, R+2h] that
    `patch_fwd` reads. The halo map is the identity inside each face, so
    only the four border strips are gathered (cubemap.py:507-532)."""
    R = cubemap.shape[1]
    E = R + 2 * h
    flat = cubemap.reshape(-1, 3)
    si = src_idx.reshape(6, E, E).long()
    top = flat[si[:, :h, :]]
    bot = flat[si[:, h + R:, :]]
    left = flat[si[:, h:h + R, :h]]
    right = flat[si[:, h:h + R, h + R:]]
    mid = torch.cat([left, cubemap, right], dim=2)
    return torch.cat([top, mid, bot], dim=1).permute(0, 3, 1, 2)


@functools.lru_cache(maxsize=16)
def _halo_border(res: int, h: int) -> np.ndarray:
    """int64 flat positions in [6, R+2h, R+2h] of the halo ring (every
    padded position outside the face's interior), in order."""
    E = res + 2 * h
    ey, ex = np.meshgrid(np.arange(E), np.arange(E), indexing="ij")
    border = (ey < h) | (ey >= h + res) | (ex < h) | (ex >= h + res)
    return np.nonzero(np.tile(border.ravel(), 6))[0].astype(np.int64)


class _PatchFilter(torch.autograd.Function):
    """The halo filter of one level's cubemap [6, R, R, 3] with JAX's hand
    VJP (`_specular_apply_patch`, `_sap_bwd`, cubemap.py:507-563). W and
    src_idx are constant tables (no gradient). The backward runs the
    transpose `patch_bwd` into the padded layout, keeps the core and adds
    the halo ring to the texels it was gathered from with one segment sum
    (`index_add_`) over the static border positions."""

    @staticmethod
    def forward(ctx, cubemap, src_idx, W, h):
        ctx.save_for_backward(src_idx, W)
        ctx.h = h
        R = cubemap.shape[1]
        padded = halo_pad(cubemap, src_idx, h)
        return patch_fwd(W, padded, R, 2 * h + 1, h).permute(0, 2, 3, 1)

    @staticmethod
    @timing.spanned("light_bwd")
    def backward(ctx, g):
        src_idx, W = ctx.saved_tensors
        h = ctx.h
        R = W.shape[-1]
        bar = patch_bwd(W, g.permute(0, 3, 1, 2), R, 2 * h + 1, h)
        bar = bar.permute(0, 2, 3, 1)                  # [6, E, E, 3]
        core = bar[:, h:h + R, h:h + R].reshape(-1, 3)
        bpos = device_constant(_halo_border, R, h, device=g.device)
        bsrc = src_idx.reshape(-1).index_select(0, bpos).long()
        bvals = bar.reshape(-1, 3).index_select(0, bpos)
        ring = torch.zeros_like(core).index_add_(0, bsrc, bvals)
        return (core + ring).reshape(6, R, R, 3), None, None, None


def _specular_apply_patch(cubemap: torch.Tensor, src_idx: torch.Tensor,
                          W: torch.Tensor, h: int) -> torch.Tensor:
    """out[f, y, x] = sum_p W[f, p, y, x] * padded[f, y+dy, x+dx]."""
    return _PatchFilter.apply(cubemap, src_idx, W, h)


def _specular_apply_dense(cubemap: torch.Tensor, M: torch.Tensor
                          ) -> torch.Tensor:
    return (M @ cubemap.reshape(-1, 3)).reshape(cubemap.shape)


def build_prefilter_tables(base_res: int, min_res: int = 16,
                           min_roughness: float = 0.08,
                           max_roughness: float = 0.5, cutoff: float = 0.99,
                           dense_max_res: int = 32, device="cuda"):
    """Every level's static prefilter operator on `device`. Returns (spec,
    arrays): spec holds ('dense',) or ('patch', h) per level; arrays the
    matrices / (src_idx, W) pairs, then the diffuse matrix."""
    levels = []
    r = base_res
    while r > min_res:
        levels.append(r)
        r //= 2
    levels.append(r)
    num = len(levels)
    if num < 3:
        roughs = [1.0] * num
    else:
        roughs = [(i / (num - 2)) * (max_roughness - min_roughness)
                  + min_roughness for i in range(num - 1)] + [1.0]
    t = lambda a: torch.as_tensor(a, device=device)
    spec, arrays = [], []
    for res, rough in zip(levels, roughs):
        if res <= dense_max_res:
            spec.append(("dense",))
            arrays.append(t(specular_matrix(res, float(rough), float(cutoff))))
        else:
            h, src_idx, W = _patch_tables(res, float(rough), float(cutoff))
            spec.append(("patch", h))
            arrays += [t(src_idx), t(W)]
    arrays.append(t(diffuse_matrix(levels[-1])))
    return tuple(spec), tuple(arrays)


def build_specular_mips_packed(base: torch.Tensor, spec, arrays,
                               min_res: int = 16):
    """Mip chain by 2x2 average pool, each level prefiltered by its
    static operator, diffuse irradiance from the coarsest unfiltered
    level (pbr/light.py:154-170). Returns (specular list, diffuse)."""
    levels = mip_chain(base, min_res)
    ops, diffuse_m = level_operators(spec, arrays)
    out = [_specular_apply_dense(lvl, *op) if sp[0] == "dense" else
           _specular_apply_patch(lvl, *op, sp[1])
           for lvl, sp, op in zip(levels, spec, ops)]
    return out, _specular_apply_dense(levels[-1], diffuse_m)


def mip_chain(base: torch.Tensor, min_res: int = 16):
    """[base, base/2, ..., min_res] by 2x2 average pool."""
    levels = [base]
    while levels[-1].shape[1] > min_res:
        levels.append(cubemap_mip(levels[-1]))
    return levels


def level_operators(spec, arrays):
    """Split `build_prefilter_tables`'s flat arrays into one tuple per level
    ((M,) for a dense level, (src_idx, W) for a patch level) and the
    diffuse matrix."""
    ops, ai = [], 0
    for sp in spec:
        k = 1 if sp[0] == "dense" else 2
        ops.append(tuple(arrays[ai:ai + k]))
        ai += k
    return ops, arrays[ai]
