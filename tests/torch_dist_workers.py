"""Multi-process runs of the port's parallel paths for the CPU tests (this
module imports no JAX, so its processes start quickly).

`run_ranks(name, payload, tmp_dir, world)` spawns `world` processes that
join one gloo process group through a file under `tmp_dir` (no TCP port),
runs the function `name` of this module on the same payload in each, and
returns their results in rank order. The group's init and collectives
time out after INIT_TIMEOUT_S and each join after JOIN_TIMEOUT_S, so a
hung rank fails its test instead of holding the run."""
import datetime
import multiprocessing
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from gi_gs_tpu_torch import config as cfg_mod
from gi_gs_tpu_torch.models.gaussians import params_from_numpy
from gi_gs_tpu_torch.ops import shading
from gi_gs_tpu_torch.ops.rasterize import RasterConfig
from gi_gs_tpu_torch.ops.rasterize.binning import Binning
from gi_gs_tpu_torch.parallel import collectives
from gi_gs_tpu_torch.parallel.data_parallel import (make_dp_phase1_step,
                                                    make_dp_phase2_step,
                                                    stack_cameras)
from gi_gs_tpu_torch.parallel.tile_sharded import (make_ts_phase1_step,
                                                   sharded_composite)
from gi_gs_tpu_torch.ops.screen_space import GIParams
from gi_gs_tpu_torch.scene.cameras import make_camera
from gi_gs_tpu_torch.train import trainer
from gi_gs_tpu_torch.train.densify import DensifyStats
from gi_gs_tpu_torch.train.optim import build_light_optimizer, build_optimizer

INIT_TIMEOUT_S = 90
JOIN_TIMEOUT_S = 240


def _entry(name, rank, world, init_file, payload, out):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    try:
        torch.save(globals()[name](payload), out)
    finally:
        dist.destroy_process_group()


def run_ranks(name, payload, tmp_dir, world=2):
    """The results of `name(payload)` on each of `world` gloo ranks."""
    ctx = multiprocessing.get_context("spawn")
    run_dir = tempfile.mkdtemp(prefix=f"{name}_", dir=str(tmp_dir))
    init_file = os.path.join(run_dir, "init")
    procs = []
    for rank in range(world):
        out = os.path.join(run_dir, f"rank{rank}.pt")
        p = ctx.Process(target=_entry, args=(name, rank, world, init_file,
                                             payload, out))
        p.start()
        procs.append((p, out))
    try:
        for p, _ in procs:
            p.join(JOIN_TIMEOUT_S)
        hung = [r for r, (p, _) in enumerate(procs) if p.is_alive()]
        assert not hung, f"{name}: ranks {hung} did not finish"
        codes = [p.exitcode for p, _ in procs]
        assert codes == [0] * world, f"{name}: rank exit codes {codes}"
    finally:
        for p, _ in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [torch.load(out, weights_only=False) for _, out in procs]


def port_binning(b: dict) -> Binning:
    t = lambda k: torch.as_tensor(np.array(b[k]))
    return Binning(ids=t("ids"), inst_tile=t("inst_tile"),
                   perm=t("perm").long(), inv_perm=t("inv_perm").long(),
                   tile_start=t("tile_start"), tile_count=t("tile_count"),
                   offsets=t("offsets"), overflow=t("overflow"),
                   max_tile_count=t("max_tile_count"))


def sharded_composite_grad(p):
    """The tile-sharded composite of p's table and binning, the loss
    sum(accum * g_acc) + sum(final_t * g_t) and this rank's partial table
    gradient."""
    cfg = RasterConfig(**p["sizes"])
    tab = torch.as_tensor(p["table"]).clone().requires_grad_(True)
    accum, final_t = sharded_composite(None, tab, port_binning(p["binning"]),
                                       cfg, p["grid"], p["hw"])
    loss = (accum * torch.as_tensor(p["g_acc"])).sum() + \
        (final_t * torch.as_tensor(p["g_t"])).sum()
    loss.backward()
    return {"loss": float(loss), "grad": tab.grad.numpy(),
            "accum": accum.detach().numpy(),
            "final_t": final_t.detach().numpy()}


def cameras(p):
    return [make_camera(R=c["R"], T=c["T"], fovx=c["fovx"], fovy=c["fovy"],
                        width=c["width"], height=c["height"], device="cpu")
            for c in p["cams"]]


def initial_state(p, cfg):
    """The train state of p: its fields, fresh optimizer state and
    statistics, p["cubemap"] and the densify generator seeded with 0."""
    params = params_from_numpy(p["fields"], p["sh"], 3, device="cpu")
    state = trainer.make_train_state(cfg, params, 1.0, seed=0)
    if "cubemap" in p:
        state = state.replace(cubemap=torch.as_tensor(p["cubemap"]))
    return state


def state_numpy(state) -> dict:
    out = dict(state.params.to_numpy())
    out.update({f"stats.{k}": getattr(state.stats, k).numpy().copy()
                for k in DensifyStats.FIELDS})
    out["cubemap"] = state.cubemap.numpy().copy()
    return out


def run_steps(step, state, p, views):
    """Steps at p["iterations"]; `views(i)` gives step i's arguments
    after the state. Returns per-step losses and stats, the collectives
    each step issued, and the final state as numpy."""
    losses, stats, calls = [], [], []
    for i, it in enumerate(p["iterations"]):
        collectives.reset_calls()
        state, aux = step(state, *views(i), it)
        calls.append(dict(collectives.calls))
        losses.append(float(aux.loss))
        stats.append(state_numpy(state))
    return {"loss": losses, "after": stats, "calls": calls,
            "aux": {k: float(getattr(aux, k)) for k in aux._fields}}


def phase1_single_steps(p):
    """The port's single-device make_phase1_step on p's one view."""
    cfg = p["cfg"]
    step = trainer.make_phase1_step(cfg, 1.0, build_optimizer(cfg.opt, 1.0))
    return _one_view_steps(step, p)


def ts_steps(p):
    """make_ts_phase1_step over the default group on p's one view."""
    cfg = p["cfg"]
    step = make_ts_phase1_step(cfg, 1.0, build_optimizer(cfg.opt, 1.0))
    return _one_view_steps(step, p)


def _one_view_steps(step, p):
    cam = cameras(p)[0]
    args = (cam, torch.as_tensor(p["images"][0]),
            torch.as_tensor(p["alphas"][0]), torch.as_tensor(p["bg"]))
    return run_steps(step, initial_state(p, p["cfg"]), p, lambda i: args)


def dp_steps(p):
    """make_dp_phase{1,2}_step over the default group on p's batch of
    views (the whole batch every step). p["lut"]: the env-BRDF LUT the
    phase-2 step reads (the tests' small one)."""
    cfg = p["cfg"]
    if "lut" in p:
        shading._brdf_lut_np = lambda *a: p["lut"]
        shading._brdf_lut_quad.cache_clear()
    tx = build_optimizer(cfg.opt, 1.0)
    if p["phase"] == 2:
        step = make_dp_phase2_step(cfg, 1.0, tx, build_light_optimizer(
            cfg.opt), device="cpu")
    else:
        step = make_dp_phase1_step(cfg, 1.0, tx)
    args = (stack_cameras(cameras(p)), torch.as_tensor(p["images"]),
            torch.as_tensor(p["alphas"]), torch.as_tensor(p["bg"]))
    return run_steps(step, initial_state(p, cfg), p, lambda i: args)


def port_config(sizes, opt, train, gi, capacity):
    c = cfg_mod.Config()
    c.model = cfg_mod.ModelConfig(capacity=capacity)
    c.opt = cfg_mod.OptimizationConfig(**opt)
    c.train = cfg_mod.TrainConfig(**train)
    c.raster = RasterConfig(**sizes)
    c.gi = GIParams(**gi)
    return c


def dryrun(p):
    """`gi_gs_tpu_torch.dryrun`'s five legs over the default group on the
    CPU, or only its multihost leg with p["multihost_only"]. p["lut"]: the
    env-BRDF LUT the phase-2 leg reads (the tests' small one)."""
    from gi_gs_tpu_torch import dryrun as dr
    shading._brdf_lut_np = lambda *a: p["lut"]
    shading._brdf_lut_quad.cache_clear()
    if p.get("multihost_only"):
        return {"multihost": dr.multihost_leg("cpu")}
    return dr.dryrun_multichip(dist.get_world_size(), device="cpu")
