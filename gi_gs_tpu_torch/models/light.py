"""Cubemap environment light (port of gi_gs_tpu/models/light.py; ref
pbr/light.py CubemapLight): the base [6, R, R, 3] cubemap is prefiltered
into a specular mip stack plus the diffuse irradiance
(`build_mips_packed`, differentiable: phase-2 training takes its gradient
through the mip chain and the prefilter), and sampled on the lat-long
grid for export and the env-TV loss (`make_latlong_sampler`, whose
backward is JAX's static sorted gather and cumsum segments). A new
environment for relighting comes from an HDRI (`load_hdr`) resampled onto
the cube (`latlong_to_cubemap`)."""
from __future__ import annotations

import functools
import math
import os
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..ops import cubemap as cm
from ..utils import timing
from ..utils.device import canonical, device_constant
from ..utils.math_utils import clip

LIGHT_MIN_RES = 16
MIN_ROUGHNESS = 0.08
MAX_ROUGHNESS = 0.5


class CubemapLight(NamedTuple):
    specular: Tuple[torch.Tensor, ...]   # len L, [6, R_i, R_i, 3]
    diffuse: torch.Tensor                # [6, 16, 16, 3]


_tables: dict = {}


def build_prefilter_tables(base_res: int, cutoff: float = 0.99,
                           device="cuda"):
    """Static prefilter operators for `build_mips_packed` on `device`
    (`cm.build_prefilter_tables`'s (spec, arrays)), uploaded once per
    (base_res, cutoff, device) and kept: every later light on that device,
    a relight or a phase-2 step's, copies nothing from the host (~1.5 GB
    at base_res 256). Made outside inference mode, so that a light built
    under the render CLI's inference mode and a phase-2 step's light
    backward share them."""
    key = (base_res, cutoff, canonical(device))
    got = _tables.get(key)
    if got is None:
        with torch.inference_mode(False):
            got = cm.build_prefilter_tables(
                base_res, min_res=LIGHT_MIN_RES, min_roughness=MIN_ROUGHNESS,
                max_roughness=MAX_ROUGHNESS, cutoff=cutoff, device=key[2])
        _tables[key] = got
    return got


def build_mips_packed(base: torch.Tensor, spec, arrays) -> CubemapLight:
    s, d = cm.build_specular_mips_packed(base, spec, arrays,
                                         min_res=LIGHT_MIN_RES)
    return CubemapLight(specular=tuple(s), diffuse=d)


def get_mip(roughness: torch.Tensor, num_levels: int) -> torch.Tensor:
    """Roughness -> fractional mip level (pbr/light.py:142-152)."""
    lo = (clip(roughness, MIN_ROUGHNESS, MAX_ROUGHNESS) - MIN_ROUGHNESS) \
        / (MAX_ROUGHNESS - MIN_ROUGHNESS) * (num_levels - 2)
    hi = (clip(roughness, MAX_ROUGHNESS, 1.0) - MAX_ROUGHNESS) \
        / (1.0 - MAX_ROUGHNESS) + num_levels - 2
    return torch.where(roughness < MAX_ROUGHNESS, lo, hi)


def envmap_dirs(res: Sequence[int] = (512, 1024), device="cpu"
                ) -> torch.Tensor:
    """Lat-long direction grid (ref get_envmap_dirs, train.py:145-156)."""
    gy, gx = torch.meshgrid(
        torch.linspace(0.0 + 1.0 / res[0], 1.0 - 1.0 / res[0], res[0],
                       device=device),
        torch.linspace(-1.0 + 1.0 / res[1], 1.0 - 1.0 / res[1], res[1],
                       device=device), indexing="ij")
    sintheta, costheta = torch.sin(gy * torch.pi), torch.cos(gy * torch.pi)
    sinphi, cosphi = torch.sin(gx * torch.pi), torch.cos(gx * torch.pi)
    return torch.stack((sintheta * sinphi, costheta, -sintheta * cosphi),
                       dim=-1)


@functools.lru_cache(maxsize=4)
def _latlong_struct(res_cube: int, h: int, w: int):
    """Static tap structure (numpy) of the seamless bilinear lookup of the
    lat-long grid in a [6, R, R, 3] cubemap (JAX light.py:93-133): tap
    texel ids [HW, 4] int64 and weights [HW, 4] f32, plus the stable
    sorted-by-texel permutation `order` [4HW] of the flat taps and the
    segment `bounds` [6R^2 + 1] of each texel in the sorted taps, which
    make the transpose a gather and a cumsum instead of a scatter."""
    R = res_cube
    gy, gx = np.meshgrid(
        np.linspace(0.0 + 1.0 / h, 1.0 - 1.0 / h, h),
        np.linspace(-1.0 + 1.0 / w, 1.0 - 1.0 / w, w), indexing="ij")
    st, ct = np.sin(gy * np.pi), np.cos(gy * np.pi)
    sp, cp = np.sin(gx * np.pi), np.cos(gx * np.pi)
    dirs = np.stack((st * sp, ct, -st * cp), axis=-1).reshape(-1, 3)
    face, fx, fy = cm._dir_to_face_uv_np(dirs.astype(np.float32))
    u = (fx + 1.0) * 0.5 * R - 0.5
    v = (fy + 1.0) * 0.5 * R - 0.5
    u0 = np.clip(np.floor(u), -1, R - 1)
    v0 = np.clip(np.floor(v), -1, R - 1)
    du = np.clip(u - u0, 0.0, 1.0)
    dv = np.clip(v - v0, 0.0, 1.0)
    emap = cm._edge_index_map(R).reshape(6, -1)
    E = R + 2
    idxs, ws = [], []
    for vv, uu, wgt in [(v0, u0, (1 - du) * (1 - dv)),
                        (v0, u0 + 1, du * (1 - dv)),
                        (v0 + 1, u0, (1 - du) * dv),
                        (v0 + 1, u0 + 1, du * dv)]:
        pidx = (vv.astype(np.int64) + 1) * E + uu.astype(np.int64) + 1
        idxs.append(emap[face, pidx])
        ws.append(wgt.astype(np.float32))
    tap_idx = np.stack(idxs, -1).astype(np.int64)
    flat_idx = tap_idx.reshape(-1)
    order = np.argsort(flat_idx, kind="stable").astype(np.int64)
    bounds = np.searchsorted(flat_idx[order],
                             np.arange(6 * R * R + 1)).astype(np.int64)
    return tap_idx, np.stack(ws, -1), order, bounds


def _latlong_table(res_cube: int, h: int, w: int, k: int) -> np.ndarray:
    """Table k (tap ids, weights, order, bounds) of `_latlong_struct`."""
    return _latlong_struct(res_cube, h, w)[k]


class _LatlongSample(torch.autograd.Function):
    """base [6, R, R, 3] -> [HW, 3]: the weighted sum of each lat-long
    pixel's four taps, with JAX's custom VJP (light.py:150-163): the tap
    cotangents are gathered in texel order and each texel's sum is the
    difference of an f32 prefix sum at its segment bounds. No scatter, no
    atomics: the backward gives the same bits on every call. The scan runs
    along the contiguous axis of a [3, 4HW] copy (a CUDA cumsum along dim
    0 scans each column in one thread)."""

    @staticmethod
    def forward(ctx, base, tap_idx, tap_w, order, bounds):
        ctx.save_for_backward(tap_w, order, bounds)
        ctx.shape = base.shape
        taps = base.reshape(-1, 3).index_select(0, tap_idx.reshape(-1))
        return (taps.reshape(-1, 4, 3) * tap_w[..., None]).sum(1)

    @staticmethod
    @timing.spanned("light_bwd")
    def backward(ctx, g):
        tap_w, order, bounds = ctx.saved_tensors
        tapg = (g.reshape(-1, 1, 3) * tap_w[..., None]).reshape(-1, 3)
        srt = tapg.t().index_select(1, order)              # [3, 4HW]
        csum = torch.cat([srt.new_zeros((3, 1)),
                          torch.cumsum(srt, dim=1, dtype=torch.float32)],
                         dim=1)
        seg = csum.index_select(1, bounds[1:]) - \
            csum.index_select(1, bounds[:-1])
        return seg.t().reshape(ctx.shape), None, None, None, None


def make_latlong_sampler(res_cube: int, res: Sequence[int] = (512, 1024)):
    """f(base [6, R, R, 3]) -> [H, W, 3], the lat-long image of
    `export_envmap` as one gather of the static tap table, whose backward
    is JAX's static sorted gather and cumsum segments (`_LatlongSample`);
    the tables stay on the base's device. Used by the per-step env-TV loss
    (train.py:409-416)."""
    h, w = res

    def sample(base: torch.Tensor) -> torch.Tensor:
        tables = [device_constant(_latlong_table, res_cube, h, w, k,
                                  device=base.device) for k in range(4)]
        return _LatlongSample.apply(base, *tables).reshape(h, w, 3)

    return sample


def export_envmap_np(base, res: Sequence[int] = (512, 1024)) -> np.ndarray:
    """Host-side export through the static tap tables (JAX light.py:80-90):
    the bilinear rule of `export_envmap` in numpy, for a cubemap
    [6, R, R, 3] given as an array or a tensor on any device."""
    if isinstance(base, torch.Tensor):
        base = base.detach().cpu().numpy()
    base = np.asarray(base)
    tap_idx, tap_w, _, _ = _latlong_struct(base.shape[1], res[0], res[1])
    out = (base.reshape(-1, 3)[tap_idx] * tap_w[..., None]).sum(axis=1)
    return out.reshape(res[0], res[1], 3).astype(np.float32)


def export_envmap(base: torch.Tensor, res: Sequence[int] = (512, 1024)
                  ) -> torch.Tensor:
    """Cubemap -> lat-long image [H, W, 3] (ref export_envmap,
    pbr/light.py:172-208)."""
    return cm.sample_cubemap(base, envmap_dirs(res, base.device))


def latlong_to_cubemap(latlong: torch.Tensor, res: int) -> torch.Tensor:
    """HDRI lat-long [H, W, 3] -> cubemap [6, res, res, 3] on its device,
    bilinear with the longitude wrapped (JAX light.py:170-195; ref
    render.py latlong_to_cubemap:64-83)."""
    dirs = torch.as_tensor(cm.texel_dirs(res), dtype=torch.float32,
                           device=latlong.device)
    # Inverse of the envmap_dirs parameterisation.
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    theta = torch.arccos(torch.clamp(y, -1.0, 1.0))        # gy * pi
    phi = torch.arctan2(x, -z)                             # gx * pi
    H, W = latlong.shape[:2]
    v = theta / math.pi * H - 0.5
    u = (phi / math.pi + 1.0) * 0.5 * W - 0.5
    u0 = torch.floor(u)
    v0 = torch.clamp(torch.floor(v), 0, H - 1)
    du, dv = u - u0, torch.clamp(v - v0, 0.0, 1.0)
    u0i = u0.to(torch.int64)
    u0w, u1 = u0i % W, (u0i + 1) % W
    v0i = v0.to(torch.int64)
    v1 = torch.clamp(v0i + 1, 0, H - 1)
    flat = latlong.reshape(-1, latlong.shape[-1]).to(torch.float32)
    c00, c01 = flat[v0i * W + u0w], flat[v0i * W + u1]
    c10, c11 = flat[v1 * W + u0w], flat[v1 * W + u1]
    du, dv = du[..., None], dv[..., None]
    return (c00 * (1 - du) * (1 - dv) + c01 * du * (1 - dv) +
            c10 * (1 - du) * dv + c11 * du * dv)


def split_envmap_loss(base: torch.Tensor, gt_envmap) -> Tuple[float, float]:
    """Fork diagnostic (pbr/light.py:119-134; JAX light.py:198-206): MSE of
    the exported lat-long's upper and lower halves against the upper half
    of a GT envmap [H, W, 3] (the fork resizes its HDRI to 1024x512)."""
    gt = torch.as_tensor(gt_envmap, dtype=torch.float32, device=base.device)
    exported = export_envmap(base, (gt.shape[0], gt.shape[1]))
    h_half = exported.shape[0] // 2
    upper = float(((exported[:h_half] - gt[:h_half]) ** 2).mean())
    lower = float(((exported[h_half:] - gt[:h_half]) ** 2).mean())
    return upper, lower


def decode_hdr(path: str) -> Tuple[np.ndarray, str]:
    """Radiance .hdr / .exr -> ([H, W, 3] f32 RGB, the decoder's name).
    Decoder order as JAX's `load_hdr` (light.py:211-245): cv2, then
    imageio, then the built-in Radiance decoder (.hdr only). A missing
    file, or a file no decoder takes, raises."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    try:
        import cv2
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is not None:
            return (cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32),
                    "cv2")
    except ImportError:
        pass
    try:
        import imageio.v3 as iio
    except ImportError:
        iio = None
    if iio is not None:
        try:
            return np.asarray(iio.imread(path), np.float32)[..., :3], \
                "imageio"
        except Exception as e:
            # Only .hdr has a further decoder; for any other format report
            # imageio's own failure.
            if not path.lower().endswith(".hdr"):
                raise RuntimeError(f"imageio failed to decode {path}") from e
    if path.lower().endswith(".hdr"):
        return _read_radiance_hdr(path), "built-in"
    raise RuntimeError(
        f"cannot decode {path}: no cv2/imageio available and the built-in "
        "decoder handles Radiance .hdr only")


def load_hdr(path: str) -> np.ndarray:
    """Radiance .hdr / .exr -> [H, W, 3] f32 RGB (ref read_hdr,
    render.py:32-45); see `decode_hdr`."""
    return decode_hdr(path)[0]


def _read_radiance_hdr(path: str) -> np.ndarray:
    """Minimal Radiance RGBE (.hdr) decoder (JAX light.py:248-306): header,
    '-Y H +X W' resolution line, then per-scanline new-style RLE
    (2, 2, hi, lo marker) or flat RGBE. Exposure/colorcorr headers are
    ignored, as cv2 does."""
    with open(path, "rb") as f:
        if not f.readline().startswith(b"#?"):
            raise ValueError(f"{path}: not a Radiance HDR file")
        while f.readline() not in (b"\n", b"\r\n", b""):
            pass
        res = f.readline().split()
        if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
            raise ValueError(f"{path}: unsupported resolution line {res}")
        h, w = int(res[1]), int(res[3])
        data = np.frombuffer(f.read(), np.uint8)

    rgbe = np.zeros((h, w, 4), np.uint8)
    pos = 0
    for y in range(h):
        if pos + 4 <= data.size and data[pos] == 2 and data[pos + 1] == 2 \
                and (int(data[pos + 2]) << 8 | int(data[pos + 3])) == w:
            pos += 4  # new-style RLE scanline, one component at a time
            for c in range(4):
                x = 0
                while x < w:
                    count = int(data[pos])
                    pos += 1
                    if count > 128:       # run
                        rgbe[y, x:x + count - 128, c] = data[pos]
                        pos += 1
                        x += count - 128
                    else:                 # literal
                        rgbe[y, x:x + count, c] = data[pos:pos + count]
                        pos += count
                        x += count
        else:                             # flat scanline
            if pos + 4 * w > data.size:
                raise ValueError(
                    f"{path}: truncated scanline {y} (old-style RLE files "
                    "are not supported by the built-in decoder)")
            rgbe[y] = data[pos:pos + 4 * w].reshape(w, 4)
            pos += 4 * w
    if pos != data.size:
        # A clean decode consumes the buffer exactly; leftovers mean the
        # scanline structure was misparsed (old-style RLE read as flat).
        raise ValueError(
            f"{path}: {data.size - pos} trailing bytes after decode: "
            "unsupported scanline encoding (old-style RLE?)")
    exp = rgbe[..., 3].astype(np.int32)
    # mantissa * 2^(e-136), as cv2/stb (Radiance's own convention adds 0.5
    # to the mantissa; the reference decodes through cv2)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136)).astype(
        np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]
