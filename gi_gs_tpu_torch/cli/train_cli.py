"""Training CLI (port of gi_gs_tpu/cli/train_cli.py:73-307; ref
train.py:171-527): the two-phase schedule with random camera order.
Phase 1 (iterations up to --pbr_iteration): photometric + normal losses
on a random background if asked. Phase 2 (above it): deferred PBR against
the learnable cubemap on a black background, SSAO with --indirect and SSR.
Densification, periodic held-out evaluation (phase 2 through the PBR view
with the training GI settings), checkpoints and PLY.

    python -m gi_gs_tpu_torch.cli.train_cli --source_path SCENE \
        --model_path OUT [--device cpu] [--iterations N] \
        [--pbr_iteration M --indirect ...]

Same flags as the JAX CLI (`config.add_args`). Writes cfg_args.json,
cameras.json, eval_{it}.json, chkpnt{it}.pt (readable by the port's render
CLI) and point_cloud/iteration_{it}/point_cloud.ply.

Data parallelism (`--dp N`, JAX train_cli.py:131-160,218-231) runs one
process per device under torch.distributed's launcher:

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m gi_gs_tpu_torch.cli.train_cli --dp N ... [--device cpu]

`LOCAL_RANK` picks the card; the process group is NCCL on CUDA and gloo
with --device cpu. Every rank draws the same N views from the same seeded
rng and takes its own (`parallel.data_parallel`), so the draw needs no
communication; only rank 0 writes files. --dp must equal the launcher's
WORLD_SIZE; --dp 1 is the single-process path.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from argparse import ArgumentParser
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from .. import config as config_mod
from ..models import light as light_mod
from ..models.gaussians import create_from_points
from ..ops.rasterize.pipeline import bucket_cap_instances
from ..parallel import data_parallel as dp_mod
from ..renderer import render
from ..scene.cameras import camera_to_json
from ..scene.dataset import load_scene
from ..train import trainer as trainer_mod
from ..train.optim import build_light_optimizer, build_optimizer
from ..utils import checkpoint as ckpt
from ..utils import image_utils, timing
from ..utils.device import resolve_device
from .render_cli import render_pbr_view


@torch.no_grad()
@timing.suspended()
def evaluate(cfg, state, records, light_tables=None, max_views: int = 8
             ) -> Dict:
    """Held-out PSNR/SSIM (ref training_report, train.py:553-818): the
    Gaussian render in phase 1; in phase 2 (`light_tables` given: the
    phase-2 step's prefilter tables) the PBR view with the training GI
    settings and the light of `state.cubemap`. Left out of the per-stage
    step times."""
    dev = state.params.device
    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.model.white_background
                      else [0.0, 0.0, 0.0], device=dev)
    light = None if light_tables is None else \
        light_mod.build_mips_packed(state.cubemap, *light_tables)
    psnrs, ssims = [], []
    for rec in records[:max_views]:
        cam = rec.camera(dev)
        image = torch.as_tensor(rec.image, device=dev)
        alpha = torch.as_tensor(rec.alpha, device=dev)
        gt = torch.clamp(image * alpha + bg[:, None, None] * (1 - alpha), 0, 1)
        if light is None:
            img = render(cam, state.params, bg, cfg.raster, cfg.gi,
                         derive_normal=False,
                         compute_occlusion=False)["render"]
        else:
            img = render_pbr_view(cfg, state, cam, bg,
                                  light=light)["render_rgb"]
        img = torch.clamp(img, 0.0, 1.0)
        psnrs.append(float(image_utils.psnr(img, gt)))
        ssims.append(float(image_utils.ssim(img, gt)))
    return {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)),
            "n_views": len(psnrs)}


def _init_data_parallel(dp: int, device: torch.device) -> torch.device:
    """Join the process group of a `torch.distributed.run` launch of
    `dp` processes: NCCL on the card LOCAL_RANK, gloo on the CPU. Returns
    this rank's device."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != dp:
        raise ValueError(
            f"--dp {dp}: data-parallel training runs one process per device "
            f"under `python -m torch.distributed.run --nproc_per_node {dp}`, "
            f"but WORLD_SIZE is {world}")
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            rank=int(os.environ["RANK"]), world_size=world)
    return device


def main(argv=None):
    parser = ArgumentParser(description="gi_gs_tpu_torch training")
    config_mod.add_args(parser)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    cfg = config_mod.from_args(args)
    if not cfg.model.source_path or not cfg.model.model_path:
        raise ValueError("--source_path and --model_path are required")
    device = resolve_device(args.device)
    dp = max(int(cfg.train.dp), 1)
    if dp == 1:
        return _train(cfg, device, dp)
    device = _init_data_parallel(dp, device)
    try:
        return _train(cfg, device, dp)
    finally:
        dist.destroy_process_group()


def _train(cfg, device: torch.device, dp: int):
    """The training loop on `device`; with dp > 1, this rank's part of a
    data-parallel run (the process group is open)."""
    writer = dp == 1 or dist.get_rank() == 0
    say = print if writer else (lambda *a, **k: None)
    if writer:
        os.makedirs(cfg.model.model_path, exist_ok=True)
        config_mod.save_cfg(cfg, cfg.model.model_path)
    scene = load_scene(
        cfg.model.source_path, images=cfg.model.images,
        eval_split=cfg.model.eval, resolution=cfg.model.resolution,
        white_background=cfg.model.white_background,
        max_cameras=cfg.model.max_cameras or None)
    if writer:
        with open(os.path.join(cfg.model.model_path, "cameras.json"),
                  "w") as f:
            json.dump([camera_to_json(i, r) for i, r in
                       enumerate(scene.train_cameras + scene.test_cameras)],
                      f)

    params = create_from_points(scene.points, scene.colors,
                                capacity=cfg.model.capacity,
                                max_sh_degree=cfg.model.sh_degree,
                                device=device)
    state = trainer_mod.make_train_state(cfg, params, scene.cameras_extent,
                                         seed=cfg.train.seed)
    first_iter = 0
    if cfg.train.start_checkpoint:
        state, extra = ckpt.load_train_state(cfg.train.start_checkpoint,
                                             device)
        first_iter = extra.get("iteration", 0)
        say(f"Loaded checkpoint {cfg.train.start_checkpoint} @ {first_iter}")
    tx = build_optimizer(cfg.opt, scene.cameras_extent)
    ltx = build_light_optimizer(cfg.opt)

    # Instance capacity from a probe of the real splat-tile population; it
    # grows on overflow. An explicitly smaller --cap_instances is kept.
    probe_cams = [r.camera(device) for r in scene.train_cameras[:3]]
    cap0 = min(trainer_mod.probe_cap_instances(cfg, state.params, probe_cams),
               cfg.raster.cap_instances)
    cfg.raster = dataclasses.replace(cfg.raster, cap_instances=cap0)
    say(f"instance capacity bucket: {cap0}", flush=True)
    if dp > 1:
        say(f"data-parallel over {dp} ranks ({dist.get_backend()}), "
            f"{dp} views per step", flush=True)
    step_of_phase = {}

    def get_step(phase2: bool):
        """The phase's step, made at its first use (the phase-2 factories
        build the prefilter tables once). All read cfg.raster at every
        call, so capacity growth needs no new step."""
        if phase2 not in step_of_phase:
            ext = scene.cameras_extent
            if dp > 1:
                step_of_phase[phase2] = (
                    dp_mod.make_dp_phase2_step(cfg, ext, tx, ltx,
                                               device=device) if phase2
                    else dp_mod.make_dp_phase1_step(cfg, ext, tx))
            else:
                step_of_phase[phase2] = (
                    trainer_mod.make_phase2_step(cfg, ext, tx, ltx, device)
                    if phase2 else
                    trainer_mod.make_phase1_step(cfg, ext, tx))
        return step_of_phase[phase2]

    def grow_capacity(overflow: int):
        new_cap = bucket_cap_instances(cfg.raster.cap_instances + overflow,
                                       headroom=1.3)
        cfg.raster = dataclasses.replace(cfg.raster, cap_instances=new_cap)
        say(f"instance capacity bucket -> {new_cap} "
              f"(overflowed by {overflow})", flush=True)

    def grow_cap_tile(max_tile_count: int):
        """Instances past cap_tile are the most occluded ones but may still
        be visible: grow (chunk-aligned) instead of truncating."""
        ch = cfg.raster.chunk
        new_cap = -(-int(max_tile_count * 1.3) // ch) * ch
        cfg.raster = dataclasses.replace(cfg.raster, cap_tile=new_cap)
        say(f"tile depth capacity -> {new_cap} "
              f"(max per-tile population {max_tile_count})", flush=True)

    train_recs = scene.train_cameras
    cams = [r.camera(device) for r in train_recs]
    images = [torch.as_tensor(r.image, device=device) for r in train_recs]
    alphas = [torch.as_tensor(r.alpha, device=device) for r in train_recs]
    bg_const = torch.tensor([1.0, 1.0, 1.0] if cfg.model.white_background
                            else [0.0, 0.0, 0.0], device=device)

    stack = []
    t0 = t_report = time.time()
    it_report = first_iter
    rng = np.random.RandomState(cfg.train.seed)

    def next_view():
        nonlocal stack
        if not stack:
            stack = list(range(len(train_recs)))
        return stack.pop(rng.randint(0, len(stack)))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # per step: loss and device-synchronised seconds; per report: the
    # population and capacities
    steps, reports = [], []
    for iteration in range(first_iter + 1, cfg.opt.iterations + 1):
        if iteration % 1000 == 0:
            state = state.replace(params=state.params.one_up_sh_degree())
        phase2 = iteration > cfg.train.pbr_iteration
        if cfg.opt.random_background and not phase2:
            bg = torch.as_tensor(rng.rand(3).astype(np.float32), device=device)
        else:
            bg = bg_const
        step = get_step(phase2)
        t_step = time.perf_counter()
        if dp > 1:
            # one distinct view per rank and step (JAX's documented
            # deviation: dp gradient samples per iteration); every view
            # must have one resolution, as Blender/TensoIR scenes do
            vis = [next_view() for _ in range(dp)]
            state, aux = step(state,
                              dp_mod.stack_cameras([cams[v] for v in vis]),
                              torch.stack([images[v] for v in vis]),
                              torch.stack([alphas[v] for v in vis]), bg,
                              iteration)
        else:
            vi = next_view()
            state, aux = step(state, cams[vi], images[vi], alphas[vi], bg,
                              iteration)
        sync()
        steps.append({"iteration": iteration, "loss": float(aux.loss),
                      "seconds": time.perf_counter() - t_step,
                      "phase": 2 if phase2 else 1})
        # Capacity checks on the densify cadence as well as the report
        # cadence, so drop events off the report cadence are seen.
        if iteration % 100 == 0 or iteration == first_iter + 1 or \
                iteration % cfg.opt.densification_interval == 0:
            loss = steps[-1]["loss"]
            overflow = int(aux.overflow)
            if overflow > 0:
                grow_capacity(overflow)
            mtc = int(aux.max_tile_count)
            if mtc > cfg.raster.cap_tile:
                grow_cap_tile(mtc)
            alive = int(state.params.alive.sum())
            dropped = int(aux.densify_dropped)
            # Densification wanted more slots than exist, or the live
            # population is at the ceiling: double the Gaussian capacity.
            cap = state.params.capacity
            if (dropped > 0 or alive > 0.92 * cap) and \
                    iteration < cfg.opt.densify_until_iter and \
                    cfg.model.max_capacity and cap < cfg.model.max_capacity:
                new_cap = min(cap * 2, cfg.model.max_capacity)
                state = trainer_mod.grow_state(state, new_cap)
                say(f"[{iteration}] Gaussian capacity {cap} -> {new_cap} "
                      f"(alive {alive}, densify dropped {dropped})",
                      flush=True)
            now = time.time()
            ips = (iteration - it_report) / max(now - t_report, 1e-9)
            t_report, it_report = now, iteration
            reports.append({"iteration": iteration, "loss": loss,
                            "alive": alive,
                            "capacity": state.params.capacity,
                            "cap_instances": cfg.raster.cap_instances,
                            "cap_tile": cfg.raster.cap_tile,
                            "densify_dropped": dropped})
            say(f"[{iteration}] loss {loss:.5f} l1 {float(aux.l1):.5f} "
                  f"psnr {float(aux.psnr):.2f} alive {alive}"
                  + (f" dropped {dropped}" if dropped else "") +
                  f" {ips:.2f} it/s", flush=True)

        if writer and iteration in cfg.train.test_iterations and \
                scene.test_cameras:
            n_eval = (len(scene.test_cameras)
                      if iteration == cfg.opt.iterations else 8)
            metrics = evaluate(
                cfg, state, scene.test_cameras,
                get_step(True).light_tables if phase2 else None,
                max_views=n_eval)
            print(f"[ITER {iteration}] eval: {metrics}", flush=True)
            with open(os.path.join(cfg.model.model_path,
                                   f"eval_{iteration}.json"), "w") as f:
                json.dump(metrics, f)

        if writer and (iteration in cfg.train.save_iterations or
                       iteration in cfg.train.checkpoint_iterations or
                       iteration == cfg.opt.iterations):
            path = os.path.join(cfg.model.model_path, f"chkpnt{iteration}.pt")
            ckpt.save_state(path, state, {"iteration": iteration})
            ckpt.save_gaussians_ply(
                os.path.join(cfg.model.model_path,
                             f"point_cloud/iteration_{iteration}",
                             "point_cloud.ply"), state.params)
            print(f"[ITER {iteration}] saved checkpoint {path}", flush=True)

    say(f"Training complete in {time.time() - t0:.1f}s")
    return {"state": state, "steps": steps, "reports": reports, "cfg": cfg}


if __name__ == "__main__":
    main()
