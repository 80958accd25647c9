"""The serving path of the render CLI: `build_light` and
`render_pbr_view` (gi_gs_tpu_torch/cli/render_cli.py, frozen)."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models import light as light_mod
from ..ops import screen_space
from ..ops.shading import pbr_shading_chw
from ..renderer import render
from ..scene.cameras import compute_view_dirs
from ..utils import image_utils, math_utils, timing
from ..utils.device import resolve_device


@torch.inference_mode()
def build_light(cfg, cubemap: torch.Tensor) -> light_mod.CubemapLight:
    """Prefiltered light of the cubemap base on its device."""
    with timing.stage("prefilter_tables", cubemap.device):
        spec, arrays = light_mod.build_prefilter_tables(
            cubemap.shape[1], device=cubemap.device)
    with timing.stage("build_mips", cubemap.device):
        return light_mod.build_mips_packed(cubemap, spec, arrays)


@torch.inference_mode()
def render_pbr_view(cfg, state, cam, bg: torch.Tensor, light=None,
                    albedo_ratio: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
    """Full PBR + SSR render of one view (render.py:206-341). `state`
    carries `params` (GaussianParams) and `cubemap`; the view renders on
    their device."""
    dev = resolve_device(state.params.device)
    if light is None:
        light = build_light(cfg, state.cubemap)
    t = cfg.train
    res = render(cam, state.params, bg, cfg.raster, cfg.gi, inference=True,
                 pad_normal=True, derive_normal=True, compute_occlusion=True)
    rmax, rmin = 1.0, 0.04
    roughness_map = res["roughness_map"] * (rmax - rmin) + rmin
    albedo_map = res["albedo_map"]
    if albedo_ratio is not None:
        albedo_map = albedo_map * albedo_ratio[:, None, None]
    metallic_map = res["metallic_map"]
    normal_mask = res["normal_mask"]
    with timing.stage("shading", dev):
        pbr = pbr_shading_chw(
            light=light, normals=res["normal_map_world"],
            view_dirs=compute_view_dirs(cam), albedo=albedo_map,
            roughness=roughness_map, mask=normal_mask, tone=t.tone,
            gamma=t.gamma, occlusion=res["occlusion_map"],
            metallic=metallic_map if t.metallic else None)
        b = bg[:, None, None]
        diffuse_rgb = torch.where(
            normal_mask, torch.clamp(pbr["diffuse_rgb"], 0, 1), b)
        specular_rgb = torch.where(
            normal_mask, torch.clamp(pbr["specular_rgb"], 0, 1), b)
        render_rgb = torch.where(normal_mask, pbr["render_rgb"], b)
    if t.metallic:
        f0 = (1.0 - metallic_map) * 0.04 + albedo_map * metallic_map
    else:
        f0 = torch.full_like(albedo_map, 0.04)
        metallic_map = torch.zeros_like(roughness_map)

    with timing.stage("ssr", dev):
        linear_rgb = math_utils.srgb_to_linear(render_rgb)
        irr, _ = screen_space.ssr(
            res["out_normal_view"], res["depth_pos"], linear_rgb, albedo_map,
            roughness_map, metallic_map, f0, cam.fx, cam.fy, cfg.gi)
        irr2 = image_utils.median_blur_3x3(math_utils.linear_to_srgb(irr))
        render_rgb = torch.where(normal_mask, render_rgb + irr2, b)
    return {
        "render_rgb": render_rgb, "diffuse_rgb": diffuse_rgb,
        "specular_rgb": specular_rgb, "indirect": irr2,
        "albedo_map": albedo_map, "roughness_map": roughness_map,
        "metallic_map": metallic_map, "normal_map": res["normal_map"],
        "normal_map_from_depth": res["normal_map_from_depth"],
        "normal_mask": normal_mask, "depth_map": res["depth_map"],
        "occlusion_map": res["occlusion_map"], "render_raw": res["render"],
        "overflow": res["overflow"],
    }
