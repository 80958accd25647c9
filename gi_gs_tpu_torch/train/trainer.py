"""Training steps of both phases (port of gi_gs_tpu/train/trainer.py;
ref training(), train.py:171-527).

Phase 1: photometric L1 + D-SSIM, world-frame normal consistency and
normal TV, one backward through the rasterizer (the compositing backward
is the CUDA kernel `csrc/composite_bwd.cu` on the card), per-group Adam,
then the densify / prune / opacity-reset schedule.
Phase 2 (deferred PBR, train.py:330-421): the G-buffer render (SSAO on
with --indirect), split-sum shading against the light prefiltered from
the learnable cubemap, SSR indirect diffuse, BRDF/env regularisers; one
backward to the Gaussian fields, the densification hook and the cubemap
(through the patch filter's backward, `csrc/patch_bwd.cu` on the card),
the same schedule, then the light's Adam and cubemap = max(cubemap, 0).

The JAX steps are jitted functions with the schedule under lax.cond; its
conditions depend only on the host iteration, so here they are plain
`if`s. The per-step stages are timed by `utils/timing.stage` when timing
is on: the renderer's own stages (activations, preprocess, binning,
composite, derive, ssao, post), then loss, backward, optimizer and
densify; phase 2 adds build_mips, shading, ssr, env_tv and
light_optimizer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch

from ..config import Config
from ..models import light as light_mod
from ..models.gaussians import GaussianParams, grow_params
from ..ops import screen_space, shading
from ..renderer import render
from ..scene.cameras import Camera, compute_view_dirs
from ..utils import image_utils, math_utils, timing
from ..utils.device import device_constant, resolve_device
from . import losses
from .densify import DensifyStats, densify_and_prune, reset_opacity, update_stats
from .optim import (GroupAdam, build_light_optimizer, build_optimizer,
                    surgery_grow, surgery_new_slots, surgery_reset_group,
                    trainable_view)


@dataclasses.dataclass
class TrainState:
    params: GaussianParams
    opt_state: Dict[str, Dict]
    stats: DensifyStats
    cubemap: torch.Tensor           # [6, R, R, 3] env light base
    light_opt_state: Dict[str, Dict]
    generator: torch.Generator      # densification noise, on the device

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


class StepAux(NamedTuple):
    loss: torch.Tensor
    l1: torch.Tensor
    normal_loss: torch.Tensor
    psnr: torch.Tensor
    densify_dropped: torch.Tensor
    overflow: torch.Tensor
    # pre-cap per-tile population: > cap_tile means instances were dropped
    # (the CLI grows cap_tile)
    max_tile_count: torch.Tensor


def make_train_state(cfg: Config, params: GaussianParams,
                     spatial_lr_scale: float, seed: int = 0,
                     tx: Optional[GroupAdam] = None) -> TrainState:
    """Fresh optimizer state and statistics, and a cubemap base drawn
    uniform in [0.25, 0.75) (CubemapLight init, pbr/light.py:103-107)
    from a generator seeded with `seed` on the parameters' device."""
    dev = params.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    if tx is None:
        tx = build_optimizer(cfg.opt, spatial_lr_scale)
    R = cfg.train.light_base_res
    base = torch.rand((6, R, R, 3), generator=gen, device=dev) * 0.5 + 0.25
    return TrainState(
        params=params, opt_state=tx.init(trainable_view(params)),
        stats=DensifyStats.zeros(params.capacity, dev), cubemap=base,
        light_opt_state=build_light_optimizer(cfg.opt).init(
            {"cubemap": base}),
        generator=gen)


def grow_state(state: TrainState, new_capacity: int) -> TrainState:
    """Grow the Gaussian capacity of the whole state: parameters re-padded,
    optimizer moments padded with zeros (counts kept), statistics padded
    with zeros (the reference's unbounded reallocation,
    gaussian_model.py:664-749)."""
    old = state.params.capacity
    if new_capacity <= old:
        return state

    def pad0(x):
        return torch.cat([x, x.new_zeros((new_capacity - old,) + x.shape[1:])])

    return state.replace(
        params=grow_params(state.params, new_capacity),
        opt_state=surgery_grow(state.opt_state, old, new_capacity),
        stats=DensifyStats(*(pad0(getattr(state.stats, f))
                             for f in DensifyStats.FIELDS)))


@torch.no_grad()
def probe_cap_instances(cfg: Config, params: GaussianParams, cameras,
                        max_views: int = 3) -> int:
    """The (gaussian, tile) instance count over a camera sample, rounded
    up to a capacity bucket (the reference's per-frame `num_rendered`
    allocation, rasterizer_impl.cu:582-592)."""
    from ..ops.rasterize.pipeline import bucket_cap_instances, count_instances
    cov3d = params.get_covariance(1.0)
    opacity = params.get_opacity()
    worst = 0
    for cam in cameras[:max_views]:
        worst = max(worst, count_instances(
            params.xyz, cov3d, cam.w2c, cam.full_proj, cam.tanfovx,
            cam.tanfovy, cam.height, cam.width, cfg.raster, opacity=opacity))
    return bucket_cap_instances(worst)


def _gt_image(image, alpha, bg):
    return torch.clamp(image * alpha + bg[:, None, None] * (1.0 - alpha),
                       0.0, 1.0)


def _masked_l1(a, b, mask):
    """F.l1_loss(a[:, mask], b[:, mask]) with a boolean [H, W] mask."""
    m = mask[None].to(torch.float32)
    diff = (a - b).abs() * m
    return diff.sum() / torch.clamp(m.sum() * a.shape[0], min=1.0)


def phase1_view_loss(cfg: Config, params: GaussianParams,
                     ndc_zeros: Optional[torch.Tensor], camera: Camera,
                     image, alpha, bg, tile_group=None,
                     normal_weight: float = 1.0):
    """Per-view phase-1 loss (train.py:309-327): photometric L1 + D-SSIM,
    world-frame normal consistency at `normal_weight` (the reference's
    hard-coded 1.0, train.py:324; upstream GS-IR semantics, as the JAX
    trainer) and normal TV. Returns (loss, aux). tile_group: the
    compositing sharded over that process group (the tile-sharded step;
    gradients are then per-rank partials)."""
    res = render(camera, params, bg, cfg.raster, cfg.gi, derive_normal=True,
                 compute_occlusion=False, ndc_offset=ndc_zeros,
                 tile_group=tile_group)
    with timing.stage("loss", params.device):
        gt = _gt_image(image, alpha, bg)
        l1 = image_utils.l1_loss(res["render"], gt)
        loss = (1.0 - cfg.opt.lambda_dssim) * l1 + cfg.opt.lambda_dssim * (
            1.0 - image_utils.ssim(res["render"], gt))
        normal_loss = _masked_l1(res["normal_map_world"],
                                 res["normal_map_from_depth"],
                                 res["normal_from_depth_mask"])
        loss = loss + normal_weight * normal_loss
        loss = loss + cfg.train.normal_tv_weight * losses.tv_loss(
            gt, res["normal_map"], pad=1, step=1)
    aux = {"l1": l1, "normal_loss": normal_loss, "render": res["render"],
           "gt": gt, "visibility": res["visibility_filter"],
           "radii": res["radii"], "overflow": res["overflow"],
           "max_tile_count": res["max_tile_count"]}
    return loss, aux


def loss_and_grads(cfg: Config, params: GaussianParams, camera: Camera,
                   image, alpha, bg, tile_group=None,
                   normal_weight: float = 1.0):
    """Phase-1 loss of one view and its gradients: (loss, aux, grads of
    the trainable fields, ndc_grad [C, 2]); with `tile_group`, this
    rank's partial gradients of the tile-sharded loss."""
    view = {f: t.detach().requires_grad_(True)
            for f, t in trainable_view(params).items()}
    ndc = torch.zeros((params.capacity, 2), dtype=torch.float32,
                      device=params.device, requires_grad=True)
    with torch.enable_grad():
        loss, aux = phase1_view_loss(cfg, params.replace(**view), ndc,
                                     camera, image, alpha, bg, tile_group,
                                     normal_weight)
        with timing.stage("backward", params.device):
            leaves = list(view.values()) + [ndc]
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    gs = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, gs)]
    grads = dict(zip(view, gs[:-1]))
    return loss.detach(), aux, grads, gs[-1]


def _apply_schedule_updates(cfg: Config, state: TrainState,
                            grads: Dict[str, torch.Tensor], ndc_grad,
                            aux_render: Dict[str, Any], iteration: int,
                            tx: GroupAdam, cameras_extent: float):
    """Optimizer step + densification schedule (trainer.py:157-227).
    Returns (state, densify_dropped)."""
    dev = state.params.device
    with timing.stage("optimizer", dev):
        new_view, opt_state = tx.step(grads, state.opt_state,
                                      trainable_view(state.params))
        params = state.params.replace(**new_view)
        stats = update_stats(state.stats, ndc_grad, aux_render["visibility"],
                             aux_render["radii"])
    o = cfg.opt
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    with timing.stage("densify", dev):
        if (o.densify_from_iter < iteration < o.densify_until_iter
                and iteration % o.densification_interval == 0):
            # size threshold after the first opacity reset, else disabled
            # (train.py:504)
            size_thr = (o.size_screen_threshold
                        if iteration > o.opacity_reset_interval else None)
            noise = torch.randn((params.capacity, 3), generator=state.generator,
                                device=dev)
            params, stats, new_slots, dropped = densify_and_prune(
                noise, params, stats, o.densify_grad_threshold, 0.05,
                cameras_extent, size_thr, o.percent_dense)
            opt_state = surgery_new_slots(opt_state, new_slots)
        if iteration < o.densify_until_iter and (
                iteration % o.opacity_reset_interval == 0 or
                (cfg.model.white_background and
                 iteration == o.densify_from_iter)):
            params = reset_opacity(params)
            opt_state = surgery_reset_group(opt_state, "opacity")
    return state.replace(params=params, opt_state=opt_state,
                         stats=stats), dropped


def make_phase1_step(cfg: Config, cameras_extent: float, tx: GroupAdam,
                     normal_weight: float = 1.0):
    """Returns step(state, camera, image, alpha, bg, iteration) ->
    (state, StepAux). normal_weight: the weight of the normal-consistency
    loss, the reference's hard-coded 1.0 (train.py:324); the quality gate
    passes it through."""

    @timing.spanned("step")
    def step(state: TrainState, camera: Camera, image, alpha, bg,
             iteration: int):
        loss, aux, grads, ndc_grad = loss_and_grads(
            cfg, state.params, camera, image, alpha, bg,
            normal_weight=normal_weight)
        new_state, dropped = _apply_schedule_updates(
            cfg, state, grads, ndc_grad, aux, int(iteration), tx,
            cameras_extent)
        with torch.no_grad():
            psnr = image_utils.psnr(aux["render"], aux["gt"])
        return new_state, StepAux(loss, aux["l1"].detach(),
                                  aux["normal_loss"].detach(), psnr, dropped,
                                  aux["overflow"], aux["max_tile_count"])

    return step


# ---------------------------------------------------------------------------
# Phase 2: deferred PBR
# ---------------------------------------------------------------------------

def phase2_view_loss(cfg: Config, light: light_mod.CubemapLight,
                     params: GaussianParams,
                     ndc_zeros: Optional[torch.Tensor], camera: Camera,
                     image, alpha, bg, view_dirs):
    """Per-view deferred-PBR loss (train.py:330-407; JAX trainer.py:265-
    346): render the G-buffer, shade it against the prefiltered `light`
    (shading normals and occlusion detached), add the SSR indirect of the
    sRGB->linear direct render (median-blurred), then L1, the masked or
    unmasked BRDF TV and the 0.001 roughness/metallic prior. The per-step
    env-TV term is the caller's. Returns (loss, aux)."""
    t = cfg.train
    dev = params.device
    res = render(camera, params, bg, cfg.raster, cfg.gi, derive_normal=True,
                 compute_occlusion=t.indirect, ndc_offset=ndc_zeros)
    with timing.stage("shading", dev):
        gt = _gt_image(image, alpha, bg)
        rmax, rmin = 1.0, 0.04
        roughness_map = res["roughness_map"] * (rmax - rmin) + rmin
        metallic_map = res["metallic_map"]
        albedo_map = res["albedo_map"]
        normal_mask = res["normal_mask"]            # [1, H, W]
        occlusion = (res["occlusion_map"] if t.indirect
                     else torch.ones_like(roughness_map))
        pbr = shading.pbr_shading_chw(
            light=light, normals=res["normal_map_world"].detach(),
            view_dirs=view_dirs, albedo=albedo_map, roughness=roughness_map,
            mask=normal_mask, tone=t.tone, gamma=t.gamma,
            occlusion=occlusion.detach(),
            metallic=metallic_map if t.metallic else None)
        render_direct = torch.where(normal_mask, pbr["render_rgb"],
                                    bg[:, None, None])
        if t.metallic:
            f0 = (1.0 - metallic_map) * 0.04 + albedo_map * metallic_map
        else:
            f0 = torch.ones_like(albedo_map) * 0.04
            metallic_map = torch.zeros_like(roughness_map)
    with timing.stage("ssr", dev):
        linear_rgb = math_utils.srgb_to_linear(render_direct)
        irr, _ = screen_space.ssr(
            res["out_normal_view"].detach(), res["depth_pos"].detach(),
            linear_rgb.detach(), albedo_map, roughness_map, metallic_map, f0,
            camera.fx, camera.fy, cfg.gi)
        irr = image_utils.median_blur_3x3(math_utils.linear_to_srgb(irr))
        render_rgb = render_direct + irr
    with timing.stage("loss", dev):
        pbr_l1 = image_utils.l1_loss(render_rgb, gt)
        brdf_maps = torch.cat([albedo_map, roughness_map, metallic_map], 0)
        # both terms on the device and a select, as JAX's jnp.where: no
        # host sync on the mask
        has_bg = (normal_mask == 0).sum() > 0
        brdf_tv = torch.where(
            has_bg, losses.masked_tv_loss(normal_mask, gt, brdf_maps),
            losses.tv_loss(gt, brdf_maps, pad=1, step=1))
        loss = pbr_l1 + brdf_tv * t.brdf_tv_weight
        m = normal_mask.to(torch.float32)
        msum = math_utils.clip(m.sum(), 1.0)
        lamb = ((1.0 - roughness_map) * m).sum() / msum + \
            (metallic_map * m).sum() / msum
        loss = loss + 0.001 * lamb
    aux = {"l1": pbr_l1, "normal_loss": torch.zeros((), device=dev),
           "render": render_rgb, "gt": gt,
           "visibility": res["visibility_filter"], "radii": res["radii"],
           "overflow": res["overflow"],
           "max_tile_count": res["max_tile_count"]}
    return loss, aux


def env_tv_loss(cubemap_base: torch.Tensor) -> torch.Tensor:
    """Per-step environment-map TV on the exported 512 x 1024 lat-long
    grid (train.py:409-416)."""
    envmap = light_mod.make_latlong_sampler(cubemap_base.shape[1])(
        cubemap_base)
    return ((envmap[1:] - envmap[:-1]) ** 2).mean() + \
        ((envmap[:, 1:] - envmap[:, :-1]) ** 2).mean()


def phase2_loss_and_grads(cfg: Config, light_tables, params: GaussianParams,
                          cubemap: torch.Tensor, camera: Camera, image, alpha,
                          bg, view_dirs):
    """Phase-2 loss of one view plus env-TV, and its gradients: (loss, aux,
    grads of the trainable fields, ndc_grad [C, 2], cubemap grad).
    light_tables: `light.build_prefilter_tables`'s (spec, arrays)."""
    dev = params.device
    view = {f: x.detach().requires_grad_(True)
            for f, x in trainable_view(params).items()}
    ndc = torch.zeros((params.capacity, 2), dtype=torch.float32, device=dev,
                      requires_grad=True)
    base = cubemap.detach().requires_grad_(True)
    with torch.enable_grad():
        with timing.stage("build_mips", dev):
            light = light_mod.build_mips_packed(base, *light_tables)
        loss, aux = phase2_view_loss(cfg, light, params.replace(**view), ndc,
                                     camera, image, alpha, bg, view_dirs)
        with timing.stage("env_tv", dev):
            loss = loss + env_tv_loss(base) * cfg.train.env_tv_weight
        with timing.stage("backward", dev):
            leaves = list(view.values()) + [ndc, base]
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    gs = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, gs)]
    return loss.detach(), aux, dict(zip(view, gs[:-2])), gs[-2], gs[-1]


def make_phase2_step(cfg: Config, cameras_extent: float, tx: GroupAdam,
                     ltx: GroupAdam, device=None):
    """Returns step(state, camera, image, alpha, bg, iteration) ->
    (state, StepAux) of the deferred-PBR phase (train.py:330-421). The
    background is black whatever `bg` is (train.py:264-265). The
    prefilter tables (and the env-BRDF LUT) are built once here on
    `device` (default: the card), as JAX builds them once per step
    factory."""
    dev = resolve_device(device)
    light_tables = light_mod.build_prefilter_tables(cfg.train.light_base_res,
                                                    device=dev)
    device_constant(shading._brdf_lut_quad, 256, device=dev)

    @timing.spanned("step")
    def step(state: TrainState, camera: Camera, image, alpha, bg,
             iteration: int):
        bg = torch.zeros_like(bg)
        view_dirs = compute_view_dirs(camera)
        loss, aux, grads, ndc_grad, light_grad = phase2_loss_and_grads(
            cfg, light_tables, state.params, state.cubemap, camera, image,
            alpha, bg, view_dirs)
        new_state, dropped = _apply_schedule_updates(
            cfg, state, grads, ndc_grad, aux, int(iteration), tx,
            cameras_extent)
        with timing.stage("light_optimizer", state.params.device):
            cube, light_opt_state = ltx.step(
                {"cubemap": light_grad}, state.light_opt_state,
                {"cubemap": state.cubemap})
            cubemap = torch.clamp(cube["cubemap"], min=0.0)
        new_state = new_state.replace(cubemap=cubemap,
                                      light_opt_state=light_opt_state)
        with torch.no_grad():
            psnr = image_utils.psnr(torch.clamp(aux["render"], 0.0, 1.0),
                                    aux["gt"])
        return new_state, StepAux(loss, aux["l1"].detach(),
                                  aux["normal_loss"], psnr, dropped,
                                  aux["overflow"], aux["max_tile_count"])

    step.light_tables = light_tables
    return step
