"""Cubemap environment light (port of gi_gs_tpu/models/light.py; ref
pbr/light.py CubemapLight): the base [6, R, R, 3] cubemap is prefiltered
into a specular mip stack plus the diffuse irradiance
(`build_mips_packed`, differentiable: phase-2 training takes its gradient
through the mip chain and the prefilter), and sampled on the lat-long
grid for export and the env-TV loss (`make_latlong_sampler`)."""
from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..ops import cubemap as cm
from ..utils.device import device_constant
from ..utils.math_utils import clip

LIGHT_MIN_RES = 16
MIN_ROUGHNESS = 0.08
MAX_ROUGHNESS = 0.5


class CubemapLight(NamedTuple):
    specular: Tuple[torch.Tensor, ...]   # len L, [6, R_i, R_i, 3]
    diffuse: torch.Tensor                # [6, 16, 16, 3]


def build_prefilter_tables(base_res: int, cutoff: float = 0.99,
                           device="cuda"):
    """Static prefilter operators for `build_mips_packed` on `device`."""
    return cm.build_prefilter_tables(
        base_res, min_res=LIGHT_MIN_RES, min_roughness=MIN_ROUGHNESS,
        max_roughness=MAX_ROUGHNESS, cutoff=cutoff, device=device)


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
def _latlong_taps(res_cube: int, h: int, w: int):
    """numpy (tap texel ids [HW, 4] int64, tap weights [HW, 4] f32) of the
    seamless bilinear lookup of the lat-long grid in a [6, R, R, 3]
    cubemap: the taps of JAX's `_latlong_struct` (light.py:93-133)."""
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
    return np.stack(idxs, -1).astype(np.int64), np.stack(ws, -1)


def _latlong_tap_idx(res_cube: int, h: int, w: int) -> np.ndarray:
    return _latlong_taps(res_cube, h, w)[0]


def _latlong_tap_w(res_cube: int, h: int, w: int) -> np.ndarray:
    return _latlong_taps(res_cube, h, w)[1]


def make_latlong_sampler(res_cube: int, res: Sequence[int] = (512, 1024)):
    """f(base [6, R, R, 3]) -> [H, W, 3], the lat-long image of
    `export_envmap` as one gather of the static tap table (kept on the
    base's device); autograd's index scatter-add is its backward (JAX
    transposes it by a static cumsum instead). Used by the per-step env-TV
    loss (train.py:409-416)."""
    h, w = res

    def sample(base: torch.Tensor) -> torch.Tensor:
        idx = device_constant(_latlong_tap_idx, res_cube, h, w,
                              device=base.device)
        wts = device_constant(_latlong_tap_w, res_cube, h, w,
                              device=base.device)
        taps = base.reshape(-1, 3)[idx]                     # [HW, 4, 3]
        return (taps * wts[..., None]).sum(1).reshape(h, w, 3)

    return sample


def export_envmap(base: torch.Tensor, res: Sequence[int] = (512, 1024)
                  ) -> torch.Tensor:
    """Cubemap -> lat-long image [H, W, 3] (ref export_envmap,
    pbr/light.py:172-208)."""
    return cm.sample_cubemap(base, envmap_dirs(res, base.device))
