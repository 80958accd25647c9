"""Cubemap environment light (port of the render-path parts of
gi_gs_tpu/models/light.py; ref pbr/light.py CubemapLight): the base
[6, R, R, 3] cubemap is prefiltered into a specular mip stack plus the
diffuse irradiance."""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from ..ops import cubemap as cm

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
    lo = (torch.clamp(roughness, MIN_ROUGHNESS, MAX_ROUGHNESS) - MIN_ROUGHNESS) \
        / (MAX_ROUGHNESS - MIN_ROUGHNESS) * (num_levels - 2)
    hi = (torch.clamp(roughness, MAX_ROUGHNESS, 1.0) - MAX_ROUGHNESS) \
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


def export_envmap(base: torch.Tensor, res: Sequence[int] = (512, 1024)
                  ) -> torch.Tensor:
    """Cubemap -> lat-long image [H, W, 3] (ref export_envmap,
    pbr/light.py:172-208)."""
    return cm.sample_cubemap(base, envmap_dirs(res, base.device))
