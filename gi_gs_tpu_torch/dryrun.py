"""Multi-rank dry run of the port's parallel training paths (counterpart of
the JAX package's `__graft_entry__.dryrun_multichip` and
`tools/multihost_dryrun.py`) on tiny shapes: 100 Gaussians in capacity
128, 32x16 views, 8x16 tiles.

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m gi_gs_tpu_torch.dryrun [--device cpu]

runs `dryrun_multichip(N)` on every rank: NCCL with one card per rank
(`LOCAL_RANK`), or gloo with `--device cpu`. Its legs, each ending with a
check that every rank holds a bit-identical state:

1. `make_dp_phase1_step` twice on N distinct cameras, with
   densify_from_iter 0, interval 2 and threshold 1e-8: the densification
   fires at step 2 and must change the alive count;
2. `make_dp_phase2_step` (SSAO, SSR, the light's gradient averaged): the
   cubemap must change;
3. `sharded_composite`, one image's tiles over the ranks, forward and
   backward: finite;
4. two `make_ts_phase1_step` steps: xyz must move;
5. `multihost_leg`: each rank builds only its own view's image (its own
   seed) and publishes it to the batch with an all_gather; two DP steps
   (the densification fires), `grow_state` to twice the capacity on every
   rank, and a third step.

Rank 0 prints one `dryrun ... OK` line per leg, as the JAX dry run does.
"""
from __future__ import annotations

import argparse
import datetime
import os
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from .config import Config, ModelConfig, OptimizationConfig, TrainConfig
from .models.gaussians import create_from_points
from .ops.rasterize import RasterConfig
from .ops.screen_space import GIParams
from .parallel import collectives
from .parallel.data_parallel import (make_dp_phase1_step, make_dp_phase2_step,
                                     stack_cameras)
from .parallel.tile_sharded import make_ts_phase1_step, sharded_composite
from .scene.cameras import make_camera
from .train import trainer
from .train.densify import DensifyStats
from .train.optim import build_light_optimizer, build_optimizer


def _tiny_setup(device, capacity=128, n=100, w=32, h=16, seed=0):
    """The JAX dry run's scene (`__graft_entry__._tiny_setup`): the same
    RandomState draws, opacity raw 1.0."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    pts[:, 2] += 2.5
    colors = rng.uniform(0.2, 0.9, (n, 3)).astype(np.float32)
    params = create_from_points(pts, colors, capacity=capacity, device=device)
    params = params.replace(opacity=torch.full_like(params.opacity, 1.0))
    cam = make_camera(R=np.eye(3), T=np.zeros(3), fovx=1.0, fovy=0.7,
                      width=w, height=h, device=device)
    rcfg = RasterConfig(tile_h=8, tile_w=16, cap_instances=1 << 11,
                        cap_tile=128, chunk=8)
    gi = GIParams(step=4, start=2, delta=0.25)
    return params, cam, rcfg, gi


def _distinct_cameras(n, w, h, device):
    """n cameras on a ring around the scene, distinct extrinsics (every
    rank must do different work)."""
    cams = []
    for i in range(n):
        ang = 0.15 * (i - (n - 1) / 2.0)
        c, s = np.cos(ang), np.sin(ang)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        T = np.array([0.05 * i, 0.0, 0.1 * (i % 3)], np.float32)
        cams.append(make_camera(R=R, T=T, fovx=1.0, fovy=0.7, width=w,
                                height=h, device=device))
    return cams


def _config(capacity: int, rcfg: RasterConfig, gi: GIParams) -> Config:
    """Densification from iteration 0 every 2 steps at a threshold that
    every visible Gaussian passes: iteration 2 densifies."""
    cfg = Config()
    cfg.model = ModelConfig(capacity=capacity)
    cfg.opt = OptimizationConfig(densify_from_iter=0,
                                 densification_interval=2,
                                 densify_until_iter=10,
                                 densify_grad_threshold=1e-8)
    cfg.train = TrainConfig(light_base_res=64, indirect=True)
    cfg.raster = rcfg
    cfg.gi = gi
    return cfg


def state_numpy(state) -> Dict[str, np.ndarray]:
    """The replicated part of a train state as numpy arrays: the
    parameters, the densification statistics, the cubemap and every
    optimizer moment and count."""
    out = {k: v for k, v in state.params.to_numpy().items()}
    out.update({f"stats.{k}": getattr(state.stats, k).cpu().numpy()
                for k in DensifyStats.FIELDS})
    out["cubemap"] = state.cubemap.cpu().numpy()
    for name, opt in (("opt", state.opt_state),
                      ("light_opt", state.light_opt_state)):
        for grp, st in opt.items():
            out[f"{name}.{grp}.mu"] = st["mu"].cpu().numpy()
            out[f"{name}.{grp}.nu"] = st["nu"].cpu().numpy()
            out[f"{name}.{grp}.count"] = np.array(st["count"])
    return out


def assert_replicated(state, group, what: str) -> None:
    """Raise unless every rank of `group` holds the same bits in every
    array of `state_numpy(state)`: one all_reduce(MAX) of the bits and
    their negation, which leaves max == -min only where all ranks
    agree."""
    dev = state.params.device
    bits = []
    for a in state_numpy(state).values():
        a = np.ascontiguousarray(a)
        if a.dtype == np.float32:
            a = a.view(np.int32)
        bits.append(torch.as_tensor(a.astype(np.int64).reshape(-1)))
    bits = torch.cat(bits).to(dev)
    both = collectives.all_reduce_max([torch.cat([bits, -bits])], group)[0]
    hi, neg_lo = both[:bits.numel()], both[bits.numel():]
    n_diff = int((hi != -neg_lo).sum())
    if n_diff:
        raise AssertionError(f"{what}: the ranks' states differ in "
                             f"{n_diff} elements")


def _alive(state) -> int:
    return int(state.params.alive.sum())


def _say(msg: str, group) -> None:
    if dist.get_rank(group) == 0:
        print(msg, flush=True)


def multihost_leg(device, group=None) -> dict:
    """Leg 5 (tools/multihost_dryrun.py): each rank makes only its own
    view's image (RandomState(100 + rank)); every rank builds the cheap
    camera geometry of the whole batch. The images are published to the
    batch by an all_gather, and each rank's DP step reads back its own
    block. Two steps (the second densifies), `grow_state` to twice the
    capacity on every rank, a third step; the ranks stay bit-equal."""
    rank, world = collectives.rank_and_size(group)
    params, cam, rcfg, gi = _tiny_setup(device)
    cfg = _config(params.capacity, rcfg, gi)
    h, w = cam.height, cam.width
    cams = stack_cameras(_distinct_cameras(world, w, h, device))
    local = torch.as_tensor(np.random.RandomState(100 + rank).rand(
        1, 3, h, w).astype(np.float32), device=device)
    parts = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(parts, local, group=group)
    images = torch.cat(parts)
    if not torch.equal(images[rank:rank + 1], local):
        raise AssertionError("multihost: the gathered batch lost this "
                             "rank's image")
    alphas = torch.ones((world, 1, h, w), device=device)
    bg = torch.zeros(3, device=device)
    tx = build_optimizer(cfg.opt, 1.0)
    state = trainer.make_train_state(cfg, params, spatial_lr_scale=1.0, tx=tx)
    step = make_dp_phase1_step(cfg, cameras_extent=1.0, tx=tx, group=group)
    state, aux = step(state, cams, images, alphas, bg, 1)
    alive0 = _alive(state)
    state, aux = step(state, cams, images, alphas, bg, 2)
    loss2, alive1 = float(aux.loss), _alive(state)
    if not np.isfinite(loss2):
        raise AssertionError("multihost: non-finite phase-1 loss")
    if alive1 == alive0:
        raise AssertionError("multihost: the densification did not fire")
    cap0 = state.params.capacity
    state = trainer.grow_state(state, 2 * cap0)
    state, aux = step(state, cams, images, alphas, bg, 3)
    loss3 = float(aux.loss)
    if not np.isfinite(loss3):
        raise AssertionError("multihost: non-finite loss after grow_state")
    assert_replicated(state, group, "multihost")
    _say(f"multihost dryrun OK: ranks={world} densify {alive0}->{alive1} "
         f"capacity {cap0}->{state.params.capacity} loss2={loss2:.4f} "
         f"loss3={loss3:.4f}", group)
    return {"alive": (alive0, alive1), "capacity": (cap0,
                                                    state.params.capacity),
            "loss": (loss2, loss3), "state": state_numpy(state)}


def dryrun_multichip(world_size: int, device=None, group=None) -> dict:
    """The five legs over `group` (None: the default group, which must be
    initialised with `world_size` ranks) on `device` (default: the card).
    Returns each leg's losses, counts and final state (numpy); raises on
    any failed check."""
    from .utils.device import resolve_device
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise ValueError("dryrun_multichip: no torch.distributed process "
                         "group; run it under torch.distributed.run")
    _, world = collectives.rank_and_size(group)
    if world != world_size:
        raise ValueError(f"dryrun_multichip({world_size}) in a group of "
                         f"{world} ranks")
    out = {}
    params, cam, rcfg, gi = _tiny_setup(dev)
    cfg = _config(params.capacity, rcfg, gi)
    tx = build_optimizer(cfg.opt, 1.0)
    ltx = build_light_optimizer(cfg.opt)
    state = trainer.make_train_state(cfg, params, spatial_lr_scale=1.0, tx=tx)
    h, w = cam.height, cam.width
    cams = stack_cameras(_distinct_cameras(world_size, w, h, dev))
    images = torch.as_tensor(np.random.RandomState(0).rand(
        world_size, 3, h, w).astype(np.float32), device=dev)
    alphas = torch.ones((world_size, 1, h, w), device=dev)
    bg = torch.zeros(3, device=dev)

    # -- 1. phase-1 DP, two steps; step 2 densifies ---------------------
    step1 = make_dp_phase1_step(cfg, cameras_extent=1.0, tx=tx, group=group)
    state, aux = step1(state, cams, images, alphas, bg, 1)
    alive_before = _alive(state)
    state, aux = step1(state, cams, images, alphas, bg, 2)
    alive_after = _alive(state)
    if not np.isfinite(float(aux.loss)):
        raise AssertionError("phase-1 DP: non-finite loss")
    if alive_after == alive_before:
        raise AssertionError(f"phase-1 DP: the densification did not fire "
                             f"({alive_before} -> {alive_after})")
    assert_replicated(state, group, "phase-1 DP")
    out["phase1_dp"] = {"loss": float(aux.loss),
                        "alive": (alive_before, alive_after),
                        "state": state_numpy(state)}
    _say(f"dryrun phase1 DP OK: loss={float(aux.loss):.4f} "
         f"densify {alive_before}->{alive_after}", group)

    # -- 2. phase-2 DP (deferred PBR + SSAO + SSR, light grads averaged) -
    step2 = make_dp_phase2_step(cfg, cameras_extent=1.0, tx=tx, ltx=ltx,
                                group=group, device=dev)
    cube_before = state.cubemap.clone()
    state, aux2 = step2(state, cams, images, alphas, bg, 3)
    if not np.isfinite(float(aux2.loss)):
        raise AssertionError("phase-2 DP: non-finite loss")
    if torch.allclose(state.cubemap, cube_before):
        raise AssertionError("phase-2 DP: the cubemap did not change")
    assert_replicated(state, group, "phase-2 DP")
    out["phase2_dp"] = {"loss": float(aux2.loss),
                        "cubemap_change": float(
                            (state.cubemap - cube_before).abs().max()),
                        "state": state_numpy(state)}
    _say(f"dryrun phase2 DP OK: loss={float(aux2.loss):.4f}", group)

    # -- 3. tile-sharded compositing, forward and backward --------------
    from .ops.rasterize.binning import bin_and_sort
    from .ops.rasterize.preprocess import preprocess
    p = state.params
    with torch.no_grad():
        opacity = p.get_opacity()
        pre = preprocess(p.xyz, p.get_covariance(1.0), cam.w2c,
                         cam.full_proj, cam.tanfovx, cam.tanfovy, w, h,
                         cfg.raster, opacity=opacity)
        b = bin_and_sort(pre, h, w, cfg.raster)
        zeros3 = torch.zeros((p.capacity, 3), device=dev)
        zeros1 = torch.zeros((p.capacity, 1), device=dev)
        table = torch.cat([
            pre.means2d, pre.conic, opacity, zeros3 + 0.5, zeros3, zeros3,
            zeros1, zeros1, pre.depth[:, None], pre.pos_view], dim=1)
    table.requires_grad_(True)
    with torch.enable_grad():
        accum, final_t = sharded_composite(group, table, b, cfg.raster,
                                           cfg.raster.grid(h, w), (h, w))
        val = (accum ** 2).sum() + (final_t ** 2).sum()
        g, = torch.autograd.grad(val, [table])
    val = val.detach()
    if not (np.isfinite(float(val)) and np.isfinite(float(g.sum()))):
        raise AssertionError("tile-sharded compositing: non-finite forward "
                             "or backward")
    out["tile_sharded"] = {"loss": float(val), "grad": g.cpu().numpy()}
    _say(f"dryrun tile-sharded OK: loss={float(val):.4f}", group)

    # -- 4. two tile-sharded train steps ---------------------------------
    params2, *_ = _tiny_setup(dev)
    ts_state = trainer.make_train_state(cfg, params2, spatial_lr_scale=1.0,
                                        tx=tx)
    ts_step = make_ts_phase1_step(cfg, cameras_extent=1.0, tx=tx, group=group)
    xyz_before = ts_state.params.xyz.clone()
    for it in (1, 2):
        ts_state, ts_aux = ts_step(ts_state, cam, images[0], alphas[0], bg,
                                   it)
    if not np.isfinite(float(ts_aux.loss)):
        raise AssertionError("tile-sharded step: non-finite loss")
    if torch.allclose(ts_state.params.xyz, xyz_before):
        raise AssertionError("tile-sharded step: xyz did not move")
    assert_replicated(ts_state, group, "tile-sharded step")
    out["ts_train"] = {"loss": float(ts_aux.loss),
                       "state": state_numpy(ts_state)}
    _say(f"dryrun tile-sharded TRAIN step OK: loss={float(ts_aux.loss):.4f}",
         group)

    # -- 5. per-rank inputs and capacity growth mid-run -------------------
    out["multihost"] = multihost_leg(dev, group)
    _say(f"dryrun_multichip({world_size}) OK: loss={float(aux2.loss):.4f}",
         group)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo ranks on the CPU (default: one "
                         "card per rank, NCCL)")
    args = ap.parse_args(argv)
    on_cpu = args.device == "cpu"
    if on_cpu:
        dev = torch.device("cpu")
    else:
        from .utils.device import resolve_device
        dev = resolve_device(torch.device(
            "cuda", int(os.environ.get("LOCAL_RANK", "0"))))
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo" if on_cpu else "nccl",
                            timeout=datetime.timedelta(seconds=300))
    try:
        dryrun_multichip(dist.get_world_size(), device=dev)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
