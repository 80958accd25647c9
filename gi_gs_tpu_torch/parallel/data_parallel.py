"""Camera data parallelism over a `torch.distributed` process group
(port of gi_gs_tpu/parallel/data_parallel.py).

The Gaussian state (and, in phase 2, the cubemap) is replicated on every
rank. A step takes a batch of views; each rank takes its contiguous
block of it (as JAX's `P(axis)` shards the batch axis), renders its
views and averages their losses, and one backward gives its gradients.
Then, per step:
* one all_reduce averages the parameter, `ndc_grad` and (phase 2) light
  gradients over the ranks (`collectives.all_reduce_flat`);
* one all_reduce takes the maximum of the visibility, the radii, the
  overflow and max_tile_count (`collectives.all_reduce_max`), so every
  rank updates the same statistics and grows its capacities together;
* one all_reduce averages the reported scalars (loss, l1, normal loss,
  PSNR).
The replicated optimizer and densification then run on every rank; the
densify noise comes from `state.generator`, seeded the same on every
rank, so the ranks' states stay bit-identical. The reference trains one
view per step; a batch of views per step is the JAX package's documented
deviation (more gradient signal per step, losses averaged).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from ..config import Config
from ..models import light as light_mod
from ..ops import shading
from ..scene.cameras import Camera, compute_view_dirs
from ..train.optim import GroupAdam, trainable_view
from ..train.trainer import (StepAux, TrainState, _apply_schedule_updates,
                             env_tv_loss, phase1_view_loss, phase2_view_loss)
from ..utils import image_utils, timing
from ..utils.device import device_constant, resolve_device
from . import collectives

_MATRICES = ("w2c", "full_proj", "cam_pos")


def stack_cameras(cams: Sequence[Camera]) -> Camera:
    """List[Camera] -> one batched Camera (JAX's stacked pytree): the
    matrices stacked on a leading axis, the scalar fields as tuples with
    one entry per view."""
    return Camera(**{f.name: (torch.stack([getattr(c, f.name) for c in cams])
                              if f.name in _MATRICES else
                              tuple(getattr(c, f.name) for c in cams))
                     for f in dataclasses.fields(Camera)})


def _camera_at(batch: Camera, i: int) -> Camera:
    """View i of a `stack_cameras` batch."""
    return Camera(**{f.name: getattr(batch, f.name)[i]
                     for f in dataclasses.fields(Camera)})


def _local_views(cam_batch: Camera, images, alphas, group):
    """This rank's contiguous block of the batch: [(camera, image,
    alpha)]."""
    rank, world = collectives.rank_and_size(group)
    n = cam_batch.w2c.shape[0]
    if n % world:
        raise ValueError(f"a batch of {n} views does not split over "
                         f"{world} ranks")
    per = n // world
    return [(_camera_at(cam_batch, i), images[i], alphas[i])
            for i in range(rank * per, (rank + 1) * per)]


def _leaves(state: TrainState):
    view = {f: t.detach().requires_grad_(True)
            for f, t in trainable_view(state.params).items()}
    ndc = torch.zeros((state.params.capacity, 2), dtype=torch.float32,
                      device=state.params.device, requires_grad=True)
    return view, ndc


def _grad(loss, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
    with timing.stage("backward", leaves[0].device):
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(leaves, gs)]


def _reduce_and_apply(cfg: Config, state: TrainState, names, gs, auxes,
                      scalars, iteration: int, tx: GroupAdam,
                      cameras_extent: float, group):
    """The step's three all_reduces and the replicated schedule. gs: this
    rank's gradients of `names`, then ndc_grad (then the light's, which
    is returned averaged as the last of `grads`). scalars: this rank's
    (loss, l1, normal_loss, psnr). Returns (state, grads, StepAux)."""
    grads = collectives.all_reduce_flat(gs, group)
    vis = torch.stack([a["visibility"] for a in auxes]).any(0)
    radii = torch.stack([a["radii"] for a in auxes]).amax(0)
    overflow = torch.stack([a["overflow"] for a in auxes]).amax()
    mtc = torch.stack([a["max_tile_count"] for a in auxes]).amax()
    vis, radii, overflow, mtc = collectives.all_reduce_max(
        [vis, radii, overflow, mtc], group)
    new_state, dropped = _apply_schedule_updates(
        cfg, state, dict(zip(names, grads)), grads[len(names)],
        {"visibility": vis, "radii": radii}, int(iteration), tx,
        cameras_extent)
    loss, l1, normal_loss, psnr = collectives.all_reduce_flat(
        [torch.stack([s.detach().float() for s in scalars])], group)[0]
    return new_state, grads, StepAux(loss, l1, normal_loss, psnr, dropped,
                                     overflow, mtc)


def make_dp_phase1_step(cfg: Config, cameras_extent: float, tx: GroupAdam,
                        group=None):
    """Returns step(state, cam_batch, images, alphas, bg, iteration) ->
    (state, StepAux): `cam_batch` a `stack_cameras` batch of B views,
    images [B, 3, H, W], alphas [B, 1, H, W], the same on every rank of
    `group` (None: the default group); B a multiple of the group's
    size."""

    @timing.spanned("step")
    def step(state: TrainState, cam_batch: Camera, images, alphas, bg,
             iteration: int):
        views = _local_views(cam_batch, images, alphas, group)
        view, ndc = _leaves(state)
        params = state.params.replace(**view)
        with torch.enable_grad():
            per = [phase1_view_loss(cfg, params, ndc, cam, img, al, bg)
                   for cam, img, al in views]
            loss = torch.stack([l for l, _ in per]).mean()
            gs = _grad(loss, list(view.values()) + [ndc])
        auxes = [a for _, a in per]
        with torch.no_grad():
            psnr = torch.stack([image_utils.psnr(a["render"], a["gt"])
                                for a in auxes]).mean()
        mean = lambda k: torch.stack([a[k].detach() for a in auxes]).mean()
        new_state, _, aux = _reduce_and_apply(
            cfg, state, list(view), gs, auxes,
            (loss, mean("l1"), mean("normal_loss"), psnr), iteration, tx,
            cameras_extent, group)
        return new_state, aux

    return step


def make_dp_phase2_step(cfg: Config, cameras_extent: float, tx: GroupAdam,
                        ltx: GroupAdam, group=None, device=None):
    """The data-parallel deferred-PBR step (JAX data_parallel.py:102-
    191): the cubemap replicated, its gradient averaged with the
    parameters'; the loss of each rank is the mean of its views' losses
    plus env-TV once. Black background whatever `bg` is. The prefilter
    tables and the env-BRDF LUT are built once here on `device` (default:
    the card). Returns step(state, cam_batch, images, alphas, bg,
    iteration) -> (state, StepAux), arguments as make_dp_phase1_step's."""
    dev = resolve_device(device)
    light_tables = light_mod.build_prefilter_tables(cfg.train.light_base_res,
                                                    device=dev)
    device_constant(shading._brdf_lut_quad, 256, device=dev)

    @timing.spanned("step")
    def step(state: TrainState, cam_batch: Camera, images, alphas, bg,
             iteration: int):
        bg = torch.zeros_like(bg)
        views = _local_views(cam_batch, images, alphas, group)
        view, ndc = _leaves(state)
        params = state.params.replace(**view)
        base = state.cubemap.detach().requires_grad_(True)
        with torch.enable_grad():
            with timing.stage("build_mips", dev):
                light = light_mod.build_mips_packed(base, *light_tables)
            per = [phase2_view_loss(cfg, light, params, ndc, cam, img, al,
                                    bg, compute_view_dirs(cam))
                   for cam, img, al in views]
            loss = torch.stack([l for l, _ in per]).mean()
            with timing.stage("env_tv", dev):
                loss = loss + env_tv_loss(base) * cfg.train.env_tv_weight
            gs = _grad(loss, list(view.values()) + [ndc, base])
        auxes = [a for _, a in per]
        with torch.no_grad():
            psnr = torch.stack([
                image_utils.psnr(torch.clamp(a["render"], 0.0, 1.0), a["gt"])
                for a in auxes]).mean()
        l1 = torch.stack([a["l1"].detach() for a in auxes]).mean()
        new_state, grads, aux = _reduce_and_apply(
            cfg, state, list(view), gs, auxes,
            (loss, l1, torch.zeros_like(l1), psnr), iteration, tx,
            cameras_extent, group)
        with timing.stage("light_optimizer", dev):
            cube, light_opt_state = ltx.step(
                {"cubemap": grads[-1]}, state.light_opt_state,
                {"cubemap": state.cubemap})
        new_state = new_state.replace(
            cubemap=torch.clamp(cube["cubemap"], min=0.0),
            light_opt_state=light_opt_state)
        return new_state, aux

    step.light_tables = light_tables
    return step
