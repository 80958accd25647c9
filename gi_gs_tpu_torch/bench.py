"""Benchmark of the port (counterpart of the root `bench.py`): train-step
throughput at the lego config scale (800x800, 200k Gaussians) on one
NVIDIA GPU.

    python -m gi_gs_tpu_torch.bench [--device cpu]

Prints ONE JSON line on stdout:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N,
   "extra": {...}}
with the root bench's keys (its `tpu_parity` is `cuda_parity` here).
The primary metric is the phase-1 (photometric) step against the same
nominal 7 train-iters/s. `extra` carries:
  * phase2_iters_per_s — the full deferred-PBR step (SSAO + SSR with
    --indirect at the reference GI defaults, the coherent march),
  * a per-stage timing/roofline table over the port's main-path functions
    (the work per stage is the root bench's, the peaks the H100's),
  * `cuda_parity`: the exact march kernel (`gi_march`) against its plain
    version on a small analytic scene,
  * `device`: the card's name and power limit as nvidia-smi gives them.
Progress goes to stderr: kernel build seconds, each stage, each phase,
peak device memory and the kernel launch counts of the whole run.

The module constants H, W, N and CAP are read at call time, so a test can
shrink the bench (and the root bench) alike.

First line on an NVIDIA H100 80GB HBM3 at 700 W: phase 1 39.27 it/s,
phase 2 20.34 it/s, 1,032,632 instances; the stage table is in PERF.md.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

_T0 = time.time()

H = W = 800
N = 200_000
CAP = 1 << 18
BUDGET_S = 540.0   # GI_GS_BENCH_BUDGET's default, as the root bench's


def _log(msg: str) -> None:
    print(f"[bench +{time.time() - _T0:6.1f}s] {msg}", file=sys.stderr,
          flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_scene(device):
    """The root bench's scene (bench.py:60-90) on `device`: the same
    RandomState(0) draws in the same order."""
    from .config import Config, ModelConfig, OptimizationConfig, TrainConfig
    from .models.gaussians import create_from_points
    from .ops.rasterize import RasterConfig
    from .ops.screen_space import GIParams
    from .scene.cameras import make_camera
    from .train import trainer

    rng = np.random.RandomState(0)
    pts = rng.uniform(-1.0, 1.0, (N, 3)).astype(np.float32)
    pts[:, 2] = pts[:, 2] * 0.8 + 3.0
    colors = rng.uniform(0.0, 1.0, (N, 3)).astype(np.float32)
    params = create_from_points(pts, colors, capacity=CAP, device=device)

    cfg = Config()
    cfg.model = ModelConfig(capacity=CAP)
    cfg.opt = OptimizationConfig(densify_from_iter=10**9)
    cfg.train = TrainConfig(indirect=True)
    cfg.raster = RasterConfig()
    cfg.gi = GIParams()  # reference GI defaults, the coherent march

    cam = make_camera(R=np.eye(3), T=np.zeros(3), fovx=0.8, fovy=0.8,
                      width=W, height=H, device=device)
    cap_i = trainer.probe_cap_instances(cfg, params, [cam])
    cfg.raster = RasterConfig(cap_instances=cap_i)
    image = torch.as_tensor(rng.rand(3, H, W).astype(np.float32),
                            device=device)
    alpha = torch.ones((1, H, W), dtype=torch.float32, device=device)
    bg = torch.zeros(3, dtype=torch.float32, device=device)
    return cfg, params, cam, image, alpha, bg, rng


def time_steps(step, state, cam, image, alpha, bg, iters=10):
    """Seconds per step over `iters` steps at iterations 2, 3, ... after
    one warm-up step at iteration 1, and the last loss. The steps build
    new tensors and mutate none of `state`'s (functional Adam and
    statistics), so the caller's state is left as it was."""
    dev = image.device
    state, aux = step(state, cam, image, alpha, bg, 1)
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(iters):
        state, aux = step(state, cam, image, alpha, bg, 2 + i)
    _sync(dev)
    dt = (time.perf_counter() - t0) / iters
    return dt, float(aux.loss)


def stage_work(cfg, n_inst: int, light_arrays) -> dict:
    """The root bench's coarse work estimates per stage (bench.py:210-224,
    term for term): flops and bytes, bytes dominating everywhere."""
    from .ops.screen_space import direction_table
    rc, gi = cfg.raster, cfg.gi
    pairs = n_inst * rc.pixels_per_tile
    cap_i = rc.cap_instances
    nd = len(direction_table(gi)[0])
    n_samples = H * W * nd * (gi.step - gi.start)
    return {
        "preprocess": {"flops": CAP * 250, "bytes": CAP * 4 * 60},
        "binning": {"bytes": cap_i * 4 * 4 * 2 * 8},   # ~8 sort passes
        "composite_fwd": {"flops": pairs * 72, "bytes": n_inst * 128 * 4},
        "composite_fwd_bwd": {"flops": pairs * 200,
                              "bytes": n_inst * 128 * 4 * 3},
        "ssao": {"flops": n_samples * 14,
                 "bytes": n_samples / 1024 * 16 * 256 * 4},
        "ssr": {"flops": n_samples * 20,
                "bytes": n_samples / 1024 * 3 * 16 * 256 * 4},
        "build_mips": {"bytes": int(sum(a.numel() * a.element_size()
                                        for a in light_arrays))},
        "pbr_shading": {"bytes": H * W * 4 * 40},
    }


@torch.no_grad()
def stage_table(cfg, params, cam, rng, out_of_time=lambda: False):
    """Per-stage timings (bench.py:105-224) over the port's main-path
    functions, with the roofline of `stage_work` at the H100's peaks (on
    the card only). `out_of_time` is consulted between stages; once true,
    the remaining stages are skipped (reported with ms = -1)."""
    from .models import light as light_mod
    from .ops import screen_space as ss
    from .ops import shading
    from .ops.rasterize.binning import bin_and_sort
    from .ops.rasterize.composite import composite, composite_table
    from .ops.rasterize.preprocess import preprocess
    from .utils.device import device_constant
    from .utils.profiling import StageTimes

    dev = params.device
    rc = cfg.raster
    grid = rc.grid(H, W)
    cov3d = params.get_covariance(1.0)
    opacity = params.get_opacity()
    f32 = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)

    st = StageTimes()
    skipped = []

    def measure(name, fn, *args):
        if out_of_time():
            skipped.append(name)
            return None
        out = st.measure(name, fn, *args)
        _log(f"stage {name}: {st.times[name] * 1e3:.1f} ms")
        return out

    pre = measure("preprocess", lambda m, c, o: preprocess(
        m, c, cam.w2c, cam.full_proj, cam.tanfovx, cam.tanfovy, W, H, rc,
        opacity=o), params.xyz, cov3d, opacity)
    b = None
    if pre is not None:
        b = measure("binning", lambda pr: bin_and_sort(pr, H, W, rc), pre)
    n_inst = int(b.tile_count.sum()) if b is not None else 0

    if b is not None:
        zeros3 = torch.zeros((CAP, 3), device=dev)
        zeros1 = torch.zeros((CAP, 1), device=dev)
        table = composite_table(pre, opacity, zeros3 + 0.5, zeros3, zeros3,
                                zeros1, zeros1)
        measure("composite_fwd", lambda t: composite(t, b, rc, grid, (H, W)),
                table)

        def comp_grad(t):
            with torch.enable_grad():
                t = t.detach().requires_grad_(True)
                acc, ft = composite(t, b, rc, grid, (H, W))
                loss = (acc ** 2).sum() + (ft ** 2).sum()
                return torch.autograd.grad(loss, t)[0]
        measure("composite_fwd_bwd", comp_grad, table)
    else:
        skipped += ["composite_fwd", "composite_fwd_bwd"]

    # screen-space GI at reference defaults (coherent kernel)
    nv = f32(rng.rand(3, H, W))
    dp = f32(rng.rand(3, H, W) * 2 + 1)
    rgb = f32(rng.rand(3, H, W))
    gi = cfg.gi
    measure("ssao", lambda a, b_: ss.ssao(a, b_, cam.fx, cam.fy, gi), nv, dp)
    alb = f32(rng.rand(3, H, W))
    r1 = f32(rng.rand(1, H, W))
    f0 = f32(rng.rand(3, H, W).astype(np.float32) * 0.2)
    measure("ssr", lambda *a: ss.ssr(*a, cam.fx, cam.fy, gi),
            nv, dp, rgb, alb, r1, r1, f0)

    # PBR stack
    R = cfg.train.light_base_res
    spec, arrays = light_mod.build_prefilter_tables(R, device=dev)
    base = f32(rng.rand(6, R, R, 3))
    light = measure("build_mips", lambda bb: light_mod.build_mips_packed(
        bb, spec, arrays), base)
    if light is not None:
        device_constant(shading._brdf_lut_quad, 256, device=dev)
        nrm = f32(rng.randn(H, W, 3))
        nrm = nrm / torch.linalg.norm(nrm, dim=-1, keepdim=True)
        nrm = nrm.permute(2, 0, 1).contiguous()
        alb_c = f32(rng.rand(H, W, 3)).permute(2, 0, 1).contiguous()
        rough_c = f32(rng.rand(H, W, 1)).permute(2, 0, 1).contiguous()
        mask = torch.ones((1, H, W), dtype=torch.bool, device=dev)
        occ1 = torch.ones((1, H, W), dtype=torch.float32, device=dev)
        measure("pbr_shading", lambda l, a_, r_: shading.pbr_shading_chw(
            light=l, normals=nrm, view_dirs=nrm, albedo=a_, roughness=r_,
            mask=mask, tone=False, gamma=False, occlusion=occ1,
            metallic=None), light, alb_c, rough_c)
    else:
        skipped.append("pbr_shading")

    # the roofline is the card's: a CPU run reports its times alone
    table_out = st.report(stage_work(cfg, n_inst, arrays)
                          if dev.type == "cuda" else None)
    for k in table_out:
        table_out[k] = {kk: round(vv, 3) for kk, vv in table_out[k].items()}
    for k in skipped:
        table_out[k] = {"ms": -1.0, "skipped_for_budget": True}
    return table_out, n_inst


def cuda_parity(cfg, rng, device):
    """The exact march kernel (`gi_march`, csrc/gi_march.cu) against its
    plain version on `device` (the root bench's tpu_parity,
    bench.py:231-248): SSAO of a 16x144 analytic depth field. On CPU
    tensors both sides are the plain version."""
    from .ops import screen_space as ss
    gi = ss.GIParams(delta=0.25, step=4, start=2, backend="pallas_exact")
    h, w = 16, 144
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    z = 2.5 + 0.4 * np.sin(xs / 11.0) + 0.3 * np.cos(ys / 7.0)
    fx = fy = 0.9 * w
    pos = np.stack([(xs - w / 2) / fx * z, (ys - h / 2) / fy * z, z], 0)
    n = rng.randn(3, h, w).astype(np.float32)
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    n = torch.as_tensor(n, device=device)
    pos = torch.as_tensor(pos.astype(np.float32), device=device)
    out = ss.ssao(n, pos, fx, fy, gi)
    occ, _ = ss._gi_march_plain(n, pos, None, fx, fy, gi)
    ref = torch.clamp(1.0 - occ / ss.direction_table(gi)[1], 0.0, 1.0)[None]
    return {"ssao_exact_vs_oracle_maxdiff":
            float((out - ref).abs().max())}


def main(device=None) -> dict:
    """Run the bench on `device` (default: the card) and print its line;
    returns the result."""
    from .ops import cuda_kernels as ck
    from .train import trainer
    from .train.optim import build_light_optimizer, build_optimizer
    from .utils.device import card_line, resolve_device

    dev = resolve_device(device)
    # Wall-clock budget: the stage table and the parity check are skipped
    # once their share is spent, so a result is always printed.
    budget = float(os.environ.get("GI_GS_BENCH_BUDGET", str(BUDGET_S)))

    def spent_over(frac: float) -> bool:
        return (time.time() - _T0) > budget * frac

    card = card_line(dev)
    _log(f"device: {card} (torch {torch.__version__})")
    if dev.type == "cuda":
        t0 = time.time()
        ck.library()
        _log(f"kernels built and loaded in {time.time() - t0:.1f} s")
        torch.cuda.reset_peak_memory_stats(dev)
    cfg, params, cam, image, alpha, bg, rng = build_scene(dev)
    _log(f"scene built (cap_instances {cfg.raster.cap_instances})")
    state = trainer.make_train_state(cfg, params, spatial_lr_scale=1.0)
    tx = build_optimizer(cfg.opt, 1.0)
    ltx = build_light_optimizer(cfg.opt)
    step1 = trainer.make_phase1_step(cfg, cameras_extent=3.0, tx=tx)
    step2 = trainer.make_phase2_step(cfg, 3.0, tx, ltx, dev)
    _log("steps made (prefilter tables and env-BRDF LUT built)")

    ck.reset_launches()
    stages, n_inst = stage_table(cfg, params, cam, rng,
                                 out_of_time=lambda: spent_over(0.55))
    _log(f"stage table done; launches {json.dumps(ck.launches)}")
    if spent_over(0.8):
        parity = {"skipped_for_budget": True}
    else:
        parity = cuda_parity(cfg, rng, dev)
    _log(f"cuda parity done: {parity}")

    dt1, loss1 = time_steps(step1, state, cam, image, alpha, bg)
    _log(f"phase1 {1.0 / dt1:.2f} it/s")
    dt2, loss2 = time_steps(step2, state, cam, image, alpha, bg, iters=5)
    _log(f"phase2 {1.0 / dt2:.2f} it/s")
    if dev.type == "cuda":
        _log(f"peak device memory "
             f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    _log(f"kernel launches: {json.dumps(ck.launches)}")

    gi_ms = (stages.get("ssao", {}).get("ms", 0.0) +
             stages.get("ssr", {}).get("ms", 0.0))
    result = {
        "metric": "train_iters_per_s_lego800_fwd_bwd",
        "value": round(1.0 / dt1, 4),
        "unit": "iter/s",
        "vs_baseline": round(1.0 / dt1 / 7.0, 4),
        "extra": {
            "phase2_iters_per_s": round(1.0 / dt2, 4),
            "phase2_gi_fraction": round(max(gi_ms, 0.0) / 1e3 / dt2, 3),
            "rays_per_s": round(H * W / dt1, 1),
            "splats_per_s": round(n_inst / dt1, 1),
            "n_gaussians": N,
            "n_instances": n_inst,
            "resolution": [H, W],
            "device": card,
            "loss_finite": bool(np.isfinite(loss1) and np.isfinite(loss2)),
            "stages": stages,
            "cuda_parity": parity,
        },
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain versions)")
    main(ap.parse_args().device)
