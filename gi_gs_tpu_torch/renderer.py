"""Render orchestration (port of gi_gs_tpu/renderer.py; ref
gaussian_renderer render() plus the filter chain of
GaussianRasterizer.forward): activations -> SH colours -> rasterize ->
median-blurred depth -> depth->normal -> bilateral blur -> median-blurred
positions -> SSAO -> normal post-processing. Same output keys as the JAX
renderer. Differentiable with respect to the Gaussian parameters (phase-1
training differentiates it); serving callers hold `torch.inference_mode()`
themselves. The JAX stop-gradients are detaches here."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .models.gaussians import GaussianParams
from .ops import screen_space
from .ops.rasterize import RasterConfig
from .ops.rasterize.pipeline import rasterize
from .ops.screen_space import GIParams
from .scene.cameras import Camera
from .utils import image_utils, timing
from .utils.device import resolve_device
from .utils.math_utils import rotate_chw


def _norm_where_nonzero(v: torch.Tensor) -> torch.Tensor:
    n2 = (v * v).sum(dim=0, keepdim=True)
    unit = v * torch.rsqrt(torch.maximum(n2, torch.full_like(n2, 1e-24)))
    return torch.where(n2 > 0, unit, v)


def _derive_maps(out, camera: Camera, derive_normal: bool):
    """Normals from the median-blurred depth (bilateral-blurred) and the
    median-blurred view positions (__init__.py:475-537)."""
    if derive_normal:
        # The reference runs depth_to_normal outside autograd: detach the
        # depth input (JAX renderer.py:72-76).
        depth_filter = image_utils.median_blur_3x3(out.depth.detach())[0]
        normal_from_depth, depth_pos = screen_space.depth_to_normal(
            depth_filter, camera.w2c, camera.fx, camera.fy)
    else:
        normal_from_depth = torch.zeros_like(out.normal)
        depth_pos = torch.zeros_like(out.normal)
    return (image_utils.bilateral_blur_3x3(normal_from_depth),
            image_utils.median_blur_3x3(depth_pos))


def render(camera: Camera, pc: GaussianParams, bg_color: torch.Tensor,
           cfg: RasterConfig = RasterConfig(), gi: GIParams = GIParams(),
           scaling_modifier: float = 1.0,
           override_color: Optional[torch.Tensor] = None,
           inference: bool = False, pad_normal: bool = False,
           derive_normal: bool = True, compute_occlusion: bool = True,
           argmax_depth: bool = False,
           ndc_offset: Optional[torch.Tensor] = None,
           tile_group=None) -> Dict[str, torch.Tensor]:
    """Full G-buffer render of one view on the device of `pc`.
    ndc_offset: optional [N, 2] zeros; its gradient is the reference's
    screenspace_points.grad, the densification statistic.

    argmax_depth is INFERENCE-ONLY: depth and view positions are the
    argmax-weight instance's (one `composite_fwd_peak` launch on CUDA
    tensors), and the whole G-buffer, colour included, is detached, as on
    JAX's Pallas path (JAX renderer.py:44-49). The reference never
    differentiates it either (forward.cu:577-583 has no backward).

    tile_group: shard the compositing over a torch.distributed process
    group (`pipeline.rasterize`; JAX's tile_axis/tile_shards)."""
    resolve_device(pc.device)
    H, W = camera.height, camera.width
    with timing.stage("activations", pc.device):
        opacity = pc.get_opacity()
        cov3d = pc.get_covariance(scaling_modifier)
        color = (pc.colors_from_sh(camera.cam_pos) if override_color is None
                 else override_color)
        attrs = (pc.get_normal(), pc.get_albedo(), pc.get_roughness(),
                 pc.get_metallic())
    out = rasterize(
        pc.xyz, cov3d, opacity, color, *attrs, camera.w2c, camera.full_proj,
        camera.tanfovx, camera.tanfovy, H, W, bg_color, cfg,
        ndc_offset=ndc_offset, inference=inference,
        argmax_depth=argmax_depth, tile_group=tile_group)

    with timing.stage("derive", pc.device):
        normal_from_depth, depth_pos_filter = _derive_maps(
            out, camera, derive_normal)
    if compute_occlusion:
        with timing.stage("ssao", pc.device):
            occlusion = screen_space.ssao(out.normal_view, depth_pos_filter,
                                          camera.fx, camera.fy, gi)
    else:
        occlusion = torch.ones_like(out.depth)

    # post-processing (gaussian_renderer/__init__.py:157-219)
    normal_map = out.normal
    opacity_map = out.opacity
    normal_from_depth_mask = (normal_from_depth != 0).all(dim=0)
    normal_mask = (normal_map != 0).all(dim=0, keepdim=True)
    if pad_normal:
        zero, one = torch.zeros_like(opacity_map), torch.ones_like(opacity_map)
        opacity_map = torch.where(opacity_map < 0.004, zero, opacity_map)
        opacity_map = torch.where(opacity_map > 1.0 - 0.004, one, opacity_map)
        with timing.span("sync.normal_bg"):             # a host copy
            normal_bg = torch.tensor([0.0, 0.0, 1.0],
                                     device=normal_map.device)[:, None, None]
        normal_map = normal_map * opacity_map + (1.0 - opacity_map) * normal_bg
        mask_fd = (normal_from_depth == 0.0).all(dim=0, keepdim=True).float()
        normal_from_depth = normal_from_depth * (1.0 - mask_fd) + \
            mask_fd * normal_bg

    with timing.stage("post", pc.device):
        normal_from_depth = _norm_where_nonzero(normal_from_depth)
        normal_map = image_utils.median_blur_3x3(
            _norm_where_nonzero(normal_map))
        # View-space (negated) normal map, the fork's "normal_map" key.
        normals_view = -rotate_chw(camera.w2c[:3, :3], normal_map)
        out_normal_view = image_utils.median_blur_3x3(
            _norm_where_nonzero(out.normal_view))

    return {
        "render": out.color,
        "visibility_filter": out.visibility,
        "radii": out.radii,
        "opacity_map": opacity_map,
        "depth_map": out.depth,
        "normal_map_from_depth": normal_from_depth,
        "normal_from_depth_mask": normal_from_depth_mask,
        "normal_map": normals_view,
        "normal_map_world": normal_map,
        "normal_mask": normal_mask,
        "albedo_map": out.albedo,
        "roughness_map": out.roughness,
        "metallic_map": out.metallic,
        "occlusion_map": occlusion,
        "out_normal_view": out_normal_view,
        "depth_pos": depth_pos_filter,
        "overflow": out.overflow,
        "max_tile_count": out.max_tile_count,
    }
