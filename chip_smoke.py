#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gi_gs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--workdir DIR]

Phases (any failure exits non-zero):
  1. device    the card's name and power limit, torch / CUDA / nvcc versions
  2. build     the CUDA kernels from gi_gs_tpu_torch/csrc (nvcc, sm_90a)
  3. scene     a synthetic Blender scene from --seed: 3 test views of
               800x800, 300k alive Gaussians in capacity 2^19 (SH degree 3,
               random BRDF attributes), a random 256^2 cubemap, written as
               the port's chkpnt*.pt + cfg_args.json
  4. kernels   each serving kernel, the peak variant composite_fwd_peak,
               and the phase-2 kernels
               gi_march_coherent (SSAO and SSR on the same 800x800
               G-buffer, default GIParams; the keys each launch builds are
               checked bit for bit against the plain centre_offset_table)
               and patch_bwd (the three patch levels of the 256 light,
               random cotangents; bit-equal), against its plain PyTorch
               version on the card at the shapes the main path gives it,
               with times and bounds (patch_fwd and patch_bwd per level
               too, both bit-equal, with each level's grid and
               resources); a kernel's ms is
               its launches alone (CUDA events around the C launcher,
               `cuda_kernels.timed`), the plain ms the whole plain
               function
  5. slice     the port's render CLI (`render_cli.main`) over the test
               views with every launch count set to 0 just before; every
               serving kernel must have launched, the coherent march not
               (serving runs the exact march). Per-view and per-stage
               times.
  6. parity    the whole render_pbr_view on CUDA tensors (kernels) against
               CPU tensors (plain versions) on a small scene
  7. train     the port's train CLI (`train_cli.main`, phase 1) for 30
               steps on 8 train views of 800x800 initialised from the 300k
               shell points, with a densification and an opacity reset,
               launch counts set to 0 just before: composite_bwd,
               reduce_instance_grads, sh_bwd and adam must launch once per
               step
               (sh_fwd in the steps and the eval renders). Per-step
               and per-stage times, alive counts, capacity growth, peak
               memory; then 3 untimed
               steps, and 3 under torch.profiler for the device time by
               operation and the device's busy share.
  8. composite_bwd  the kernel against its plain version at the training
               path's settings: the trained state on its train view with
               the densest tile, the RasterConfig the train CLI ended with
               (cap_tile grown past the densest tile), random cotangents
     reduce_instance_grads  the per-Gaussian reduction kernel at the
               garden shapes (4,194,304 Gaussians, ~6.1 M instances in a
               capacity 1.15x that, segment lengths drawn from a garden
               step's histogram, a random unsort permutation, random rows)
               against the plain prefix-sum chain on the same rows:
               bit-equal, two launches bit-identical, both times, the byte
               bound, the f32 error against float64 segment sums
     sh_fwd, sh_bwd  the SH colour's kernel pair at bicycle's shapes
               (2^23 slots, degree 3, 15 rest rows, the colour's gradient
               as columns 6:9 of a column-major [N, 21]) against the plain
               twin on the same tensors: colour and every gradient
               bit-equal, two launches bit-identical, both times, the
               byte bound, each kernel's resources
     adam      one launch over the Gaussians' ten groups at bicycle's
               shapes (2^23 slots x 67 floats) and one over the 256^2
               cubemap, against the plain chain on the same tensors: p, mu
               and nu bit-equal; the launches' times, the byte bound
               (28 B an element) and the chain's time
  9. train parity  one phase-1 loss and its gradients on CUDA tensors
               (kernels) against CPU tensors (plain versions) at 64x48
 10. phase 2   the train CLI from phase 7's final checkpoint
               (--start_checkpoint, --pbr_iteration 30, 20 deferred-PBR
               steps, --indirect), launch counts set to 0 just before and
               read around every step: per step gi_march_coherent 2,
               patch_fwd 3, patch_bwd 3, expand, composite_fwd,
               composite_bwd, reduce_instance_grads, sh_fwd and sh_bwd 1
               each, the exact
               gi_march 0. Per-step and per-stage times, peak memory, the
               cubemap's minimum; then a
               device profile of 3 phase-2 steps, with the device time of
               the light's gather transposes and their gathers by kernel
               (index_add_, index_select, cumsum, sort); any autograd index
               backward (indexing_backward_kernel*) fails the run
 11. phase-2 parity  one phase-2 loss (env-TV included) and every gradient
               (Gaussian fields, ndc, cubemap) on CUDA tensors against CPU
               tensors at 160x48 (one full 128-column march block and a
               partial one), light_base_res 64 (one patch level)
 12. argmax  `renderer.render(..., inference=True, argmax_depth=True)`
               over the 3 test views, launches read around each view:
               composite_fwd_peak 1, composite_fwd 0; outputs finite, every
               covered peak depth inside the view's Gaussian depth range
 13. eval     the eval CLIs at full width: `render_cli --brdf_eval
               --lpips_weights` (GT albedo PNGs and random LPIPS weights
               written into the scene), `relight_cli` under a synthetic
               512x1024 .hdr (flat RGBE, encoded here) at --resolution 2
               (400x400) with --cubemap_res 256 (the decoder and whether the
               prefilter host tables came from this process's cache are
               printed), `relight_eval_cli` and `normal_eval_cli` on the
               frames renamed as the fork's batch scripts do, `collect_cli`
               over the model directory; every JSON written and finite;
               per-view ms of the albedo eval, LPIPS and relighting
 14. colmap   phase 7's scene written as a COLMAP capture (binary
               sparse/0: its 10 poses, a PINHOLE camera, RGB PNGs, the
               300k shell points as points3D.bin), loaded by `load_scene`
               through the native reader (built with g++), its cameras held
               against the Blender form's and its points against the shell;
               then the train CLI on it, 6 phase-1 and 6 phase-2 steps
               (--indirect, light_base_res 256), launch counts set to 0
               just before: every training kernel must launch
 15. parallel  (a) the tile_base compositing kernels: phase 7's trained
               state on its train view 0 at the train CLI's final
               RasterConfig (16x64 tiles, a 50 x 13 grid of 650 tiles)
               composited as 4 contiguous tile ranges (padded to 652, 163
               tiles each) one after the other: forward accumulators and
               final T bit-equal to the whole-image launch, backward rows
               summed over the ranges bit-equal to its rows, each range
               against its plain version at the tolerances of phases 4 and
               8, each range's ms and the whole launch's; (b) a
               torch.distributed group of world size 1 over NCCL
               (tcp://127.0.0.1, a free port): 3 make_dp_phase1_step
               steps on a batch of 2 of the train views and 3
               make_dp_phase2_step steps (--indirect, light 256) from
               phase 7's checkpoint, each first loss equal to the mean of
               the two views' make_phase{1,2}_step losses within 1e-5
               relative; (c) 3 make_ts_phase1_step steps against 3
               make_phase1_step steps: losses and stats.accum equal. Per
               step ms, collectives and kernel launches. One card: no
               multi-GPU run
 16. (no phase: the card test test_tiled_rasterize_matches_bruteforce_oracle
               holds the tiled rasterizer against the brute-force oracle)
 17. quality  the quality gate's reduced configs on the card
               (`gi_gs_tpu_torch.quality_gate`; tests/test_quality.py's
               sizes and bars): phase 1 at 64 px, 1200 steps on 16 ring
               views from a random cloud of 2000 points (test PSNR > 19
               dB), phase 2 at 64 px, 200 steps on 8 views, light 64
               (albedo PSNR > 18 dB, irradiance correlation > 0.75);
               steps/s of each, launch counts set to 0 just before: every
               training kernel must launch
 18. dryrun   `dryrun_multichip(1)` (gi_gs_tpu_torch/dryrun.py) over a
               world-size-1 NCCL group: its five legs (DP phase 1 with a
               densification, DP phase 2, tile-sharded compositing, two
               tile-sharded steps, grow_state mid-run), each checked for
               its change and for bit-equal ranks
 19. relight  (run after phase 6, before the first profiler session)
               the light's prefilter tables kept on the card: the store
               emptied, the first `render_cli.build_light` of a 256
               cubemap uploads them (its time and bytes to the card);
               three later builds of new cubemaps, each under the
               profiler (no host-to-device copy of 1 MB or more), in span
               mode (the root span light over prefilter_tables and
               build_mips, one light_builds) and timed with CUDA events;
               a relit light through the store bit-equal, level by level,
               to one built from a fresh `cm.build_prefilter_tables`
Phase 4 also holds composite_fwd_peak against its plain version on view 0
(accumulator rows bit-equal to composite_fwd's, <= 0.1% of covered pixels
with another peak), and phase 6 the argmax render on CUDA against CPU.
Phase 4 holds expand's tile, depth and gid rows equal to the plain
version's and prints its resources. Phases 4 and 8 print, for the
compositing kernels, the histogram of
instances per tile, the pairs the plain walk evaluates beside those left
after the kernels' sub-tile cull (the plain cull on the card; the bound
counts these, `bound_ms_unculled` all of them), and each kernel's
registers, shared memory and resident blocks per SM (phase 4 also for the
two marches' SSAO and SSR instantiations); phase 8 also checks
that two composite_bwd launches give bit-identical rows.
Then the kernel table as one JSON line (twelve kernels, and phase 19's
numbers under `relight`), the card line, and
last {"ok": true, "device": {...}}. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import copy
import datetime
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
# f32 (non-tensor-core) flop/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
SIZE = 800
CAPACITY = 1 << 19
LIGHT_RES = 256
N_VIEWS = 3
N_GAUSSIANS = 300_000
N_TRAIN_VIEWS = 8
TRAIN_STEPS = 30
PHASE2_STEPS = 20
COLMAP_P1_STEPS = 6
COLMAP_P2_STEPS = 6
PAR_STEPS = 3
TILE_RANGES = 4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """nvidia-smi's name and power limit of the current card."""
    from gi_gs_tpu_torch.utils.device import card_line as line
    return line("cuda")


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over `reps` launches after one
    warm-up, timed with CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, kernel: str, reps: int) -> float:
    """Mean device milliseconds per fn() of the `kernel` launches that
    fn() makes (summed when it makes several), after one warm-up."""
    from gi_gs_tpu_torch.ops import cuda_kernels as ck
    fn()
    with ck.timed() as ms:
        for _ in range(reps):
            fn()
    return sum(ms[kernel]) / reps


def bound(nbytes: float, flops: float):
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def kernel_entry(name, source, replaces, err, ok, tol, ms, plain_ms, nbytes,
                 flops, **extra) -> dict:
    """Logs one kernel-vs-plain check and returns its entry of the JSON
    line (without `launches`); fails if the kernel disagrees."""
    b_ms, b_by = bound(nbytes, flops)
    log(f"  {name}: max|kernel - plain| = {err:.3e} (tolerance {tol}); "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}) {extra or ''}")
    if not ok:
        fail(f"{name} disagrees with its plain version ({err})")
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None, **extra)


def tile_histogram(tile_count) -> dict:
    """Tiles per instance-count bin and the count's quantiles."""
    import torch
    tc = tile_count.to(torch.float64)
    edges = [0, 1, 256, 1024, 2048, 4096, 8192, float("inf")]
    bins = {f"{int(lo)}-{hi - 1 if hi != float('inf') else 'max'}":
            int(((tc >= lo) & (tc < hi)).sum())
            for lo, hi in zip(edges[:-1], edges[1:])}
    q = torch.quantile(tc, torch.tensor([0.1, 0.5, 0.9, 0.99],
                                        device=tc.device, dtype=torch.float64))
    return dict(tiles=int(tc.numel()), bins=bins,
                p10_p50_p90_p99=[float(v) for v in q], max=int(tc.max()),
                mean=float(tc.mean()))


def composite_work(work: dict, nbytes: float, per_contrib: float = 0.0):
    """The compositing kernels' operations bound and its keys: 13 flops
    per (instance, pixel) pair that the sub-tile walk evaluates (the plain
    walk's pairs left after the plain cull, on the card), plus
    `per_contrib` per contributing pair (every contributing pair survives
    the cull). `bound_ms_unculled` counts every pair of the plain walk, the
    PR 4 definition, for comparison."""
    pairs, culled = work["pairs"], work["culled_pairs"]
    contrib = work.get("contrib", 0)
    log(f"  pairs {pairs}, after the sub-tile cull {culled} "
        f"({culled / max(pairs, 1):.3f})")
    unculled_ms = bound(nbytes, 13.0 * pairs + per_contrib * contrib)[0]
    return (13.0 * culled + per_contrib * contrib,
            dict(pairs=pairs, culled_pairs=culled,
                 bound_ms_unculled=unculled_ms))


def march_resources(ss, name, gi, dev) -> dict:
    """Registers, shared memory and resident blocks per SM of a march
    kernel's SSAO and SSR instantiations at gi's direction table."""
    res = {k: ss.kernel_resources(name, gi, dev, with_rgb=k == "ssr")
           for k in ("ssao", "ssr")}
    log(f"  {name} resources: {res}")
    return res


def log_resources(composite, name, cfg, dev) -> dict:
    res = composite.kernel_resources(name, cfg, dev)
    log(f"  {name} resources at tile {cfg.tile_h}x{cfg.tile_w}: {res}")
    return res


# ---------------------------------------------------------------------------
# Synthetic scene
# ---------------------------------------------------------------------------

def look_at_c2w(eye: np.ndarray) -> np.ndarray:
    """Blender/OpenGL camera-to-world looking at the origin, z up."""
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, eye
    return c2w


def write_scene(root: str, rng: np.random.RandomState, n_test: int,
                size: int, n_train: int = 1) -> None:
    from gi_gs_tpu_torch.utils.image_io import write_png
    ys, xs = np.mgrid[0:size, 0:size] / size
    for split, n in (("train", n_train), ("test", n_test)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i in range(n):
            az = 2 * math.pi * (i + 0.37 * (split == "train")) / max(n, 1)
            eye = 4.0 * np.array([math.cos(az), math.sin(az), 0.45])
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": look_at_c2w(eye).tolist()})
            ph = rng.uniform(0, 2 * math.pi, 3)
            rgb = [0.5 + 0.4 * np.sin(6 * xs + 4 * ys + p) for p in ph]
            alpha = (np.hypot(xs - 0.5, ys - 0.5) < 0.3).astype(np.float64)
            img = np.stack(rgb + [alpha], -1)
            write_png(os.path.join(root, split, f"r_{i}.png"),
                      (img * 255).astype(np.uint8))
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.6911112070083618,
                       "frames": frames}, f)


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """(w, x, y, z) with w >= 0 of a rotation matrix: COLMAP's own
    conversion (the largest eigenvector of the symmetric 4x4 K)."""
    rxx, ryx, rzx, rxy, ryy, rzy, rxz, ryz, rzz = R.flat
    K = np.array([
        [rxx - ryy - rzz, 0, 0, 0],
        [ryx + rxy, ryy - rxx - rzz, 0, 0],
        [rzx + rxz, rzy + ryz, rzz - rxx - ryy, 0],
        [ryz - rzy, rzx - rxz, rxy - ryx, rxx + ryy + rzz]]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def write_colmap_model(sparse: str, cameras, images, xyz: np.ndarray,
                       rgb: np.ndarray, binary: bool = True) -> None:
    """A COLMAP model in `sparse` (binary .bin or text .txt files):
    cameras [(id, model name, width, height, params)], images [(id, qvec,
    tvec, camera id, name)] with two 2D points each, points3D xyz [N, 3]
    and rgb [N, 3] in 0..255 with errors i / N and a track of two
    observations each (written as one block)."""
    import struct
    from gi_gs_tpu_torch.scene.colmap import _CAMERA_MODELS
    model_ids = {m.name: m.id for m in _CAMERA_MODELS.values()}
    os.makedirs(sparse, exist_ok=True)
    n = len(xyz)
    err = np.arange(n) / max(n, 1)
    if not binary:
        with open(os.path.join(sparse, "cameras.txt"), "w") as f:
            f.write("# CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
            for cid, model, w, h, params in cameras:
                f.write(f"{cid} {model} {w} {h} "
                        + " ".join(repr(float(p)) for p in params) + "\n")
        with open(os.path.join(sparse, "images.txt"), "w") as f:
            f.write("# IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, "
                    "NAME\n")
            for iid, q, t, cid, name in images:
                f.write(f"{iid} " + " ".join(repr(float(v)) for v in
                                             (*q, *t))
                        + f" {cid} {name}\n1.5 2.5 -1 3.5 4.5 {iid}\n")
        with open(os.path.join(sparse, "points3D.txt"), "w") as f:
            f.write("# POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[]\n")
            for i in range(n):
                f.write(f"{i + 1} " + " ".join(repr(float(v))
                                               for v in xyz[i])
                        + " " + " ".join(str(int(v)) for v in rgb[i])
                        + f" {float(err[i])!r} 1 {i % 7} 2 {i % 5}\n")
        return
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cid, model, w, h, params in cameras:
            f.write(struct.pack("<iiQQ", cid, model_ids[model], w, h))
            f.write(struct.pack(f"<{len(params)}d", *params))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for iid, q, t, cid, name in images:
            f.write(struct.pack("<i7di", iid, *q, *t, cid))
            f.write(name.encode() + b"\x00" + struct.pack("<Q", 2))
            f.write(struct.pack("<ddQddQ", 1.5, 2.5, 2**64 - 1, 3.5, 4.5,
                                iid))
    rec = np.zeros(n, np.dtype([("id", "<u8"), ("xyz", "<f8", (3,)),
                                ("rgb", "u1", (3,)), ("err", "<f8"),
                                ("track_len", "<u8"), ("track", "<i4", (4,))]))
    rec["id"] = np.arange(1, n + 1)
    rec["xyz"], rec["rgb"], rec["err"] = xyz, rgb, err
    rec["track_len"] = 2
    rec["track"] = np.arange(n)[:, None] % np.array([7, 11, 5, 13])
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", n))
        f.write(rec.tobytes())


def blender_to_colmap(src: str, dst: str, xyz: np.ndarray, rgb: np.ndarray,
                      binary: bool = True) -> None:
    """The COLMAP form of a Blender scene made by `write_scene`: one
    PINHOLE camera with the scene's camera_angle_x, each frame's pose as a
    world-to-camera quaternion and translation, its RGB channels as
    images/{split}_{frame}.png, and the points xyz / rgb (0..255) as
    points3D."""
    from gi_gs_tpu_torch.utils.image_io import read_png, write_png
    os.makedirs(os.path.join(dst, "images"), exist_ok=True)
    images, size = [], None
    for split in ("train", "test"):
        with open(os.path.join(src, f"transforms_{split}.json")) as f:
            meta = json.load(f)
        for frame in meta["frames"]:
            stem = os.path.basename(frame["file_path"])
            pixels = read_png(os.path.join(src, split, stem + ".png"))
            size = pixels.shape[:2]
            name = f"{split}_{stem}.png"
            write_png(os.path.join(dst, "images", name), pixels[..., :3])
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1                    # OpenGL -> COLMAP axes
            w2c = np.linalg.inv(c2w)
            images.append((len(images) + 1, rotmat2qvec(w2c[:3, :3]),
                           w2c[:3, 3], 1, name))
    h, w = size
    focal = w / (2 * math.tan(meta["camera_angle_x"] / 2))
    write_colmap_model(os.path.join(dst, "sparse", "0"),
                       [(1, "PINHOLE", w, h, [focal, focal, w / 2, h / 2])],
                       images, xyz, rgb, binary)


def gaussian_fields(rng: np.random.RandomState, n: int, cap: int):
    """A noisy unit-sphere shell of Gaussians (a coherent surface for the
    depth/normal/GI stages), raw parameters padded to `cap`."""
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    xyz = d * rng.uniform(0.97, 1.03, (n, 1))
    f = dict(
        xyz=xyz, features_dc=rng.normal(0, 0.6, (n, 1, 3)),
        features_rest=rng.normal(0, 0.1, (n, 15, 3)),
        opacity=rng.normal(1.0, 1.5, (n, 1)), normal=d + rng.normal(
            0, 0.2, (n, 3)), albedo=rng.normal(0, 1, (n, 3)),
        roughness=rng.normal(0, 1, (n, 1)), metallic=rng.normal(0, 1, (n, 1)),
        scaling=rng.uniform(-5.0, -3.6, (n, 3)),
        rotation=rng.normal(size=(n, 4)))
    f["rotation"] /= np.linalg.norm(f["rotation"], axis=1, keepdims=True)
    out = {k: np.concatenate([v, np.zeros((cap - n,) + v.shape[1:])], 0)
           .astype(np.float32) for k, v in f.items()}
    out["scaling"][n:] = -10.0
    out["rotation"][n:, 0] = 1.0
    out["alive"] = np.arange(cap) < n
    return out


def random_cubemap(rng: np.random.RandomState, res: int) -> np.ndarray:
    """Smooth random environment (a few low-order lobes) plus texel noise."""
    from gi_gs_tpu_torch.ops.cubemap import texel_dirs
    dirs = texel_dirs(res)
    out = np.full(dirs.shape, 0.2)
    for _ in range(6):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        lobe = np.clip(dirs @ axis, 0, None) ** rng.uniform(2, 40)
        out += lobe[..., None] * rng.uniform(0.2, 2.0, 3)
    out *= rng.uniform(0.9, 1.1, out.shape)
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def kernel_phase(torch, dev, cfg, state, cam, light_arrays, spec):
    """Each serving kernel vs its plain version at the main path's shapes.
    Returns the kernel entries of the JSON line (without `launches`)."""
    from gi_gs_tpu_torch.ops import cubemap as cm
    from gi_gs_tpu_torch.ops import screen_space as ss
    from gi_gs_tpu_torch.ops.rasterize import binning, composite
    from gi_gs_tpu_torch.ops.rasterize.preprocess import preprocess
    from gi_gs_tpu_torch.renderer import render

    rc, gi = cfg.raster, cfg.gi
    H, W = cam.height, cam.width
    p = state.params
    entries = []

    def entry(*a, **kw):
        entries.append(kernel_entry(*a, **kw))

    with torch.inference_mode():
        opacity = p.get_opacity()
        pre = preprocess(p.xyz, p.get_covariance(), cam.w2c, cam.full_proj,
                         cam.tanfovx, cam.tanfovy, W, H, rc, opacity=opacity)
        n = p.capacity
        # -- expand ----------------------------------------------------------
        k = binning.expand(pre, H, W, rc)
        pl = binning._expand_plain(pre, H, W, rc)
        torch.cuda.synchronize()
        for key, a, b in zip(("tile", "depth", "gid", "offsets", "total"),
                             k, pl):
            if not torch.equal(a, b):
                fail(f"expand: {key} differs from the plain version in "
                     f"{int((a != b).sum())} rows")
        finite = torch.isfinite(pl[1])
        err = max(float((k[2] - pl[2]).abs().max()),
                  float((k[1][finite] - pl[1][finite]).abs().max()),
                  float((k[0] - pl[0]).abs().max()))
        total = int(pl[4])
        entry("expand", "gi_gs_tpu_torch/csrc/expand.cu",
              "gi_gs_tpu/ops/rasterize/pallas_expand.py:319", err, err == 0,
              "tile, depth and gid rows equal to the plain version's",
              kernel_ms(lambda: binning.expand(pre, H, W, rc), "expand", 20),
              cuda_ms(lambda: binning._expand_plain(pre, H, W, rc), 3),
              n * (11 * 4) + (n + 1) * 4 + rc.cap_instances * 12,
              rc.cap_instances * 60.0,
              also_replaces="gi_gs_tpu/ops/rasterize/pallas_expand.py:226 "
                            "(pack_rows, folded into expand)",
              instances=total, resources=binning.expand_resources(dev))
        # -- composite_fwd ----------------------------------------------------
        b = binning.bin_and_sort(pre, H, W, rc)
        table = composite.composite_table(
            pre, opacity, p.colors_from_sh(cam.cam_pos), p.get_normal(),
            p.get_albedo(), p.get_roughness(), p.get_metallic())
        grid = rc.grid(H, W)
        args = (table, b.ids, b.tile_start, b.tile_count, rc, grid)
        ka, kt = composite.composite_fwd(*args)
        work = {}
        pa, pt = composite._composite_fwd_plain(*args, work=work)
        torch.cuda.synchronize()
        err = max(float((ka - pa).abs().max()), float((kt - pt).abs().max()))
        ok = (torch.allclose(ka, pa, rtol=1e-5, atol=1e-3) and
              torch.allclose(kt, pt, rtol=1e-5, atol=1e-5))
        T, P = grid[0] * grid[1], rc.pixels_per_tile
        hist = tile_histogram(b.tile_count)
        log(f"  view 0 tile_count: {hist}")
        nbytes = (table.numel() * 4 + b.ids.numel() * 4 + T * 8
                  + T * 17 * P * 4)
        flops, pair_keys = composite_work(work, nbytes)
        entry("composite_fwd", "gi_gs_tpu_torch/csrc/composite_fwd.cu",
              "gi_gs_tpu/ops/rasterize/pallas_composite.py:238", err, ok,
              "rtol 1e-5, atol 1e-3 (a pixel whose T crosses 1e-4 in another "
              "rounding order keeps or drops one contribution of weight "
              "< 1e-4 x depth)",
              kernel_ms(lambda: composite.composite_fwd(*args),
                        "composite_fwd", 10),
              cuda_ms(lambda: composite._composite_fwd_plain(*args), 2),
              nbytes, flops, **pair_keys, max_tile_count=int(b.max_tile_count),
              tile_count=hist,
              resources=log_resources(composite, "composite_fwd", rc, dev))
        # -- composite_fwd_peak (the argmax-depth render's forward) ----------
        pka, pkt, pkp = composite.composite_fwd(*args, peak=True)
        work = {}
        ppa, ppt, ppp = composite._composite_fwd_plain(*args, work=work,
                                                       peak=True)
        torch.cuda.synchronize()
        if not (torch.equal(pka, ka) and torch.equal(pkt, kt)):
            fail("composite_fwd_peak: accumulator or final-T rows differ from "
                 "composite_fwd's")
        covered = ppa[:, 3] > 1e-6
        n_cov = int(covered.sum())
        n_flip = int(((pkp != ppp).any(dim=1) & covered).sum())
        err = max(float((pka - ppa).abs().max()),
                  float((pkt - ppt).abs().max()))
        log(f"  composite_fwd_peak: accumulator and final-T rows bit-equal to "
            f"composite_fwd's; peak rows differ from the plain version's on "
            f"{n_flip} of {n_cov} covered pixels (near-tie flips, limit 0.1%)")
        if n_flip > 1e-3 * n_cov:
            fail(f"composite_fwd_peak: {n_flip} of {n_cov} covered pixels "
                 "pick another peak than the plain version")
        nbytes = (table.numel() * 4 + b.ids.numel() * 4 + T * 8
                  + T * (17 + 4) * P * 4)
        flops, pair_keys = composite_work(work, nbytes)
        entry("composite_fwd_peak", "gi_gs_tpu_torch/csrc/composite_fwd.cu",
              "gi_gs_tpu/ops/rasterize/pallas_composite.py:238 (peak=True; "
              "body pallas_composite.py:165-181,207-208)", err,
              torch.allclose(pka, ppa, rtol=1e-5, atol=1e-3) and
              torch.allclose(pkt, ppt, rtol=1e-5, atol=1e-5),
              "accumulators as composite_fwd (rtol 1e-5, atol 1e-3) and "
              "bit-equal to it; peak rows equal to the plain version's on "
              "all but <= 0.1% of covered pixels (max_abs_err: the "
              "accumulators)",
              kernel_ms(lambda: composite.composite_fwd(*args, peak=True),
                        "composite_fwd_peak", 10),
              cuda_ms(lambda: composite._composite_fwd_plain(*args,
                                                             peak=True), 1),
              nbytes, flops, **pair_keys, peak_flip_pixels=n_flip,
              covered_pixels=n_cov,
              resources=log_resources(composite, "composite_fwd_peak", rc,
                                      dev))
        # -- gi_march (SSAO without RGB, SSR with RGB) -------------------------
        res = render(cam, p, torch.zeros(3, device=dev), rc, gi,
                     inference=True, pad_normal=True)
        nv, pos = res["out_normal_view"].contiguous(), res["depth_pos"]
        rgb = torch.rand(3, H, W, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
        errs, oks, ms, pms, flops = [], [], 0.0, 0.0, 0.0
        for r in (None, rgb):
            ko, kd = ss.gi_march(nv, pos, r, cam.fx, cam.fy, gi)
            work = {}
            po, pd = ss._gi_march_plain(nv, pos, r, cam.fx, cam.fy, gi,
                                        work=work)
            torch.cuda.synchronize()
            errs.append(max(float((ko - po).abs().max()),
                            float((kd - pd).abs().max())))
            oks.append(torch.allclose(ko, po, rtol=1e-5, atol=1e-4) and
                       torch.allclose(kd, pd, rtol=1e-5, atol=1e-4))
            ms += kernel_ms(lambda: ss.gi_march(nv, pos, r, cam.fx, cam.fy,
                                                gi), "gi_march", 5)
            pms += cuda_ms(lambda: ss._gi_march_plain(nv, pos, r, cam.fx,
                                                      cam.fy, gi), 1)
            flops += 20.0 * work["samples"]
        nd = ss.direction_table(gi)[0].shape[0]
        entry("gi_march", "gi_gs_tpu_torch/csrc/gi_march.cu",
              "gi_gs_tpu/ops/pallas_gi.py:522", max(errs), all(oks),
              "rtol 1e-5, atol 1e-4 (same hits; sums over ~480 directions "
              "in another order)", ms, pms,
              4 * H * W * (4 + 1) + 4 * H * W * (7 + 4) + 2 * nd * 16, flops,
              directions=nd, live_samples=int(flops / 20.0),
              calls="ssao (no rgb) + ssr (rgb)",
              resources=march_resources(ss, "gi_march", gi, dev))
        # -- gi_march_coherent (phase 2's march: SSAO and SSR, default
        # GIParams) on the same G-buffer. One launch builds the block-centre
        # keys and marches: its time covers both; the plain version reads
        # the plain table, which the kernel's keys must equal bit for bit
        tab_t = torch.as_tensor(ss.direction_table(gi)[0], device=dev)
        keys = ss.centre_offset_table(nv, pos, tab_t, cam.fx, cam.fy, gi)
        kkeys = torch.full_like(keys, -1)
        errs, oks, ms, pms, samples = [], [], 0.0, 0.0, 0
        for r in (None, rgb):
            ko, kd = ss.gi_march_coherent(nv, pos, r, cam.fx, cam.fy, gi,
                                          keys_out=kkeys)
            if not torch.equal(kkeys, keys):
                fail(f"gi_march_coherent: {int((kkeys != keys).sum())} of "
                     f"{keys.numel()} keys differ from centre_offset_table's")
            work = {}
            po, pd = ss._gi_march_coherent_plain(nv, pos, r, keys, gi,
                                                 work=work)
            torch.cuda.synchronize()
            errs.append(max(float((ko - po).abs().max()),
                            float((kd - pd).abs().max())))
            oks.append(torch.allclose(ko, po, rtol=1e-5, atol=1e-4) and
                       torch.allclose(kd, pd, rtol=1e-5, atol=1e-4))
            ms += kernel_ms(lambda: ss.gi_march_coherent(
                nv, pos, r, cam.fx, cam.fy, gi), "gi_march_coherent", 5)
            pms += cuda_ms(lambda: ss._gi_march_coherent_plain(
                nv, pos, r, keys, gi), 1)
            samples += work["samples"]
        log(f"  gi_march_coherent: its {keys.numel()} keys per launch are "
            f"bit-equal to centre_offset_table's on the card")
        # per live sample: svz's 5 flops per direction are amortised,
        # j * zs, the multiply-add of spz, two compares with their adds,
        # and for a hit 4 multiply-adds: about 8; per key (one per block,
        # direction and step, built twice: SSAO and SSR): the direction's
        # rotation (15), j * zsc and the three multiply-adds (7), two
        # divisions, two multiply-adds and two roundings (8): about 30
        entry("gi_march_coherent", "gi_gs_tpu_torch/csrc/gi_march_coherent.cu",
              "gi_gs_tpu/ops/pallas_gi.py:522 (mode=coherent; body "
              "pallas_gi.py:260-373, keys pallas_gi.py:380-431)", max(errs),
              all(oks),
              "keys bit-equal to centre_offset_table; occ and dif rtol 1e-5, "
              "atol 1e-4 (same keys and hits; sums over the directions in "
              "another order)", ms, pms,
              4 * H * W * (4 + 1) + 4 * H * W * (7 + 4) + 2 * nd * 16,
              8.0 * samples + 2 * 30.0 * keys.numel(),
              directions=nd, steps=keys.shape[3], live_samples=samples,
              keys_shape=list(keys.shape), keys_per_call=keys.numel(),
              keys_bit_equal=True, calls="ssao (no rgb) + ssr (rgb), keys "
              "built in the same launches",
              resources=march_resources(ss, "gi_march_coherent", gi, dev))
        # -- patch_fwd and patch_bwd (every patch level of the prefilter;
        # the transpose on random cotangents), per level and summed
        ops, _ = cm.level_operators(spec, light_arrays)
        gen = torch.Generator(device=dev).manual_seed(5)
        for name, replaces, tol in (
                ("patch_fwd", "gi_gs_tpu/ops/pallas_patch.py:115 (body "
                 "pallas_patch.py:39-58)", "bit-equal (same products added "
                 "in the same offset order, no FMA)"),
                ("patch_bwd", "gi_gs_tpu/ops/pallas_patch.py:146 (body "
                 "pallas_patch.py:61-80)", "bit-equal (same products added "
                 "in the same offset order, no FMA)")):
            err, levels = 0.0, []
            for lvl, sp, op in zip(cm.mip_chain(state.cubemap), spec, ops):
                if sp[0] == "dense":
                    continue
                (src, Wt), h = op, sp[1]
                R, Pp = lvl.shape[1], 2 * h + 1
                if name == "patch_fwd":
                    x = cm.halo_pad(lvl, src, h).contiguous()
                    run = lambda: cm.patch_fwd(Wt, x, R, Pp, h)
                    plain = lambda: cm._patch_fwd_plain(Wt, x, h)
                    out_numel = 6 * 3 * R * R
                else:
                    x = torch.randn(6, 3, R, R, device=dev, generator=gen)
                    run = lambda: cm.patch_bwd(Wt, x, R, Pp, h)
                    plain = lambda: cm._patch_bwd_plain(Wt, x, h)
                    out_numel = 6 * 3 * (R + 2 * h) ** 2
                ko, po = run(), plain()
                torch.cuda.synchronize()
                lvl_err = float((ko - po).abs().max())
                if not torch.equal(ko, po):
                    fail(f"{name} at R={R}: {int((ko != po).sum())} of "
                         f"{po.numel()} values differ from the plain version")
                err = max(err, lvl_err)
                nbytes = (Wt.numel() + x.numel() + out_numel) * 4
                flops = 6.0 * R * R * Pp * Pp * 3 * 2
                ms = kernel_ms(run, name, 10)
                b_ms = bound(nbytes, flops)[0]
                res = cm.patch_resources(name, R, h, dev)
                want = cm.patch_fwd_shape(R, h)["smem"]
                if name == "patch_fwd" and res["dynamic_smem_bytes"] != want:
                    fail(f"patch_fwd at R={R}: the launcher's shared memory "
                         f"{res['dynamic_smem_bytes']} B is not "
                         f"patch_fwd_shape's {want} B")
                levels.append(dict(
                    R=R, P=Pp, h=h, ms=ms, bound_ms=b_ms,
                    bound_share=b_ms / ms, plain_ms=cuda_ms(plain, 1),
                    bytes=nbytes, max_abs_err=lvl_err, **res))
                log(f"  {name} R={R} P={Pp}: {levels[-1]}")
            entry(name, f"gi_gs_tpu_torch/csrc/{name}.cu", replaces, err,
                  err == 0, tol,
                  sum(v["ms"] for v in levels),
                  sum(v["plain_ms"] for v in levels),
                  sum(v["bytes"] for v in levels),
                  sum(6.0 * v["R"] ** 2 * v["P"] ** 2 * 3 * 2 for v in levels),
                  levels=levels)
    return entries


TPU_KERNELS = [
    ("gi_gs_tpu/ops/rasterize/pallas_expand.py:319", "expand_pallas",
     "ported: expand"),
    ("gi_gs_tpu/ops/rasterize/pallas_expand.py:226", "pack_rows",
     "folded into expand"),
    ("gi_gs_tpu/ops/rasterize/pallas_composite.py:238",
     "composite_fwd_pallas", "ported: composite_fwd (peak=False, with "
     "tile_base), composite_fwd_peak (peak=True)"),
    ("gi_gs_tpu/ops/rasterize/pallas_composite.py:455",
     "composite_bwd_pallas", "ported: composite_bwd (with tile_base)"),
    ("gi_gs_tpu/ops/pallas_gi.py:522", "_march_pallas(mode=exact)",
     "ported: gi_march"),
    ("gi_gs_tpu/ops/pallas_gi.py:522", "_march_pallas(mode=coherent)",
     "ported: gi_march_coherent"),
    ("gi_gs_tpu/ops/pallas_patch.py:115", "patch_apply_fwd",
     "ported: patch_fwd"),
    ("gi_gs_tpu/ops/pallas_patch.py:146", "patch_apply_bwd",
     "ported: patch_bwd"),
]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default="",
                    help="scene/model directory (default: a temporary one)")
    args = ap.parse_args()
    t_start = time.time()

    # -- 1. device -----------------------------------------------------------
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an "
             "NVIDIA GPU")
    sys.path.insert(0, REPO)
    try:
        import gi_gs_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port's package is not beside chip_smoke.py ({e})")
    from gi_gs_tpu_torch import config as config_mod
    from gi_gs_tpu_torch.cli import render_cli
    from gi_gs_tpu_torch.models import light as light_mod
    from gi_gs_tpu_torch.models.gaussians import params_from_numpy
    from gi_gs_tpu_torch.ops import cuda_kernels as ck
    from gi_gs_tpu_torch.ops import shading
    from gi_gs_tpu_torch.ops.rasterize.pipeline import (
        bucket_cap_instances, count_instances)
    from gi_gs_tpu_torch.scene.dataset import load_scene
    from gi_gs_tpu_torch.utils import timing
    from gi_gs_tpu_torch.utils.checkpoint import state_from_numpy
    if "jax" in sys.modules or "gi_gs_tpu" in sys.modules:
        fail("the port imported JAX or the JAX package")
    dev = torch.device("cuda")
    card = card_line()
    nvcc = subprocess.run([ck.nvcc_path(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    log(f"[device] {card} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | {nvcc} | python {sys.version.split()[0]}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.time()
    so = ck.build()
    ck.library()
    log(f"[build] {os.path.relpath(so, REPO)} in {time.time() - t0:.1f} s")
    for line in ck.build_log.splitlines():
        if line.startswith("==") or "registers" in line:
            log("  " + line.strip())

    # -- 3. scene ------------------------------------------------------------
    rng = np.random.RandomState(args.seed)
    work = args.workdir or tempfile.mkdtemp(prefix="chip_smoke_")
    data, model = os.path.join(work, "scene"), os.path.join(work, "model")
    t0 = time.time()
    write_scene(data, rng, N_VIEWS, SIZE)
    fields = gaussian_fields(rng, N_GAUSSIANS, CAPACITY)
    cubemap = random_cubemap(rng, LIGHT_RES)
    scene = load_scene(data, eval_split=True)
    cams = [rec.camera(dev) for rec in scene.test_cameras]
    params = params_from_numpy(fields, 3, 3, device=dev)
    cfg = config_mod.Config()
    with torch.inference_mode():
        counts = [count_instances(params.xyz, params.get_covariance(),
                                  c.w2c, c.full_proj, c.tanfovx, c.tanfovy,
                                  c.height, c.width, cfg.raster,
                                  opacity=params.get_opacity()) for c in cams]
    log(f"[scene] {N_GAUSSIANS} Gaussians in capacity {CAPACITY}, "
        f"{len(cams)} test views {SIZE}x{SIZE}, instances per view "
        f"(dummies included) {counts}, cubemap {LIGHT_RES}^2, "
        f"{time.time() - t0:.1f} s")
    if not all(5e5 <= c <= 3e6 for c in counts):
        fail(f"instance counts {counts} outside the realistic 0.5-3M range")
    cfg.model = type(cfg.model)(source_path=data, model_path=model)
    cfg.raster = type(cfg.raster)(cap_instances=bucket_cap_instances(
        max(counts)))
    cfg.train.light_base_res = LIGHT_RES
    config_mod.save_cfg(cfg, model)
    state_from_numpy(fields, cubemap, {"iteration": 1}, model)

    # -- 4. kernels ----------------------------------------------------------
    t0 = time.time()
    shading._brdf_lut_quad(256)     # the LUT as the shading path reads it
    t_lut = time.time() - t0
    t0 = time.time()
    spec, arrays = light_mod.build_prefilter_tables(LIGHT_RES, device=dev)
    torch.cuda.synchronize()
    t_tab = time.time() - t0
    log(f"[host tables] env-BRDF LUT {t_lut:.1f} s, prefilter tables "
        f"{t_tab:.1f} s ({sum(a.numel() * a.element_size() for a in arrays) / 2**30:.2f} GiB on the card)")
    state = types.SimpleNamespace(params=params,
                                  cubemap=torch.as_tensor(cubemap, device=dev))
    log(f"[kernels] at the main path's shapes (view 0, cap_instances "
        f"{cfg.raster.cap_instances}):")
    entries = kernel_phase(torch, dev, cfg, state, cams[0], arrays, spec)
    del arrays
    # One view before the measured run: lazy CUDA library loads and the
    # host-side index caches of the shading path happen once per process.
    t0 = time.time()
    with torch.inference_mode():
        render_cli.render_pbr_view(cfg, state, cams[0],
                                   torch.zeros(3, device=dev),
                                   light=render_cli.build_light(cfg,
                                                                state.cubemap))
    torch.cuda.synchronize()
    log(f"[warm-up] one render_pbr_view with its light build: "
        f"{time.time() - t0:.2f} s")

    # -- 5. slice: the render CLI, counting launches --------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launches()
    timing.start()
    t0 = time.time()
    res = render_cli.main(["--model_path", model, "--source_path", data])
    wall = time.time() - t0
    stages = timing.stop()
    launches = dict(ck.launches)
    log(f"[slice] render_cli.main over {len(cams)} views in {wall:.1f} s; "
        f"launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    missing = [k for k in SERVING_KERNELS if launches[k] == 0]
    if missing:
        fail(f"the serving path launched no {missing}")
    if launches["gi_march_coherent"]:
        fail("the render CLI ran the coherent march; serving runs the exact "
             "one")
    if launches["composite_fwd_peak"]:
        fail("the render CLI launched composite_fwd_peak (argmax depth)")
    log("  per-view ms: " + ", ".join(f"{1e3 * s:.1f}"
                                      for s in res["view_seconds"]))
    once = ("prefilter_tables", "build_mips")
    log("  light build ms (once): " + ", ".join(
        f"{k} {1e3 * stages[k]:.1f}" for k in once))
    log("  per-view stage ms (mean over views, device synchronised at "
        "stage ends): " + ", ".join(f"{k} {1e3 * v / len(cams):.2f}"
                                   for k, v in stages.items()
                                   if k not in once))
    nvs = os.path.join(model, "test", "ours_1", "pbr", "NVS.json")
    if not os.path.exists(nvs):
        fail("NVS.json was not written")
    with open(nvs) as f:
        metrics = json.load(f)
    if not all(math.isfinite(metrics[k]) for k in ("psnr_avg", "ssim_avg")):
        fail(f"non-finite metrics {metrics}")
    with torch.inference_mode():
        light = render_cli.build_light(cfg, state.cubemap)
        out = render_cli.render_pbr_view(cfg, state, cams[0],
                                         torch.zeros(3, device=dev),
                                         light=light)
    for key, v in out.items():
        if v.dtype.is_floating_point and not bool(torch.isfinite(v).all()):
            fail(f"non-finite {key}")
    if out["render_rgb"].shape != (3, SIZE, SIZE) or int(out["overflow"]):
        fail("wrong output shape or instance overflow")
    log(f"  NVS.json {metrics}")
    del light, out

    # -- 6. parity: kernels vs plain versions end to end (small scene) --------
    t0 = time.time()
    err = parity_phase(torch, dev, config_mod, render_cli, params_from_numpy,
                       np.random.RandomState(args.seed + 1))
    log(f"[parity] render_pbr_view CUDA vs CPU plain at 64x48: worst key "
        f"{err} ({time.time() - t0:.1f} s)")

    # -- 19. relight: the light's tables kept on the card. Run here, before
    # the process's first profiler session: a later session can record no
    # device event (PERF.md, Open questions), and this phase profiles.
    relight = relight_phase(torch, dev, cfg,
                            np.random.RandomState(args.seed + 10))

    # -- 7. train: the phase-1 train CLI, counting launches -------------------
    train_launches, train_res, train_data = train_phase(
        torch, dev, ck, timing, work, np.random.RandomState(args.seed + 2))

    # -- 8. composite_bwd at the training path's settings ---------------------
    entries.insert(2, composite_bwd_phase(torch, dev, train_res, train_data))
    entries.insert(3, reduce_phase(torch, dev,
                                   np.random.RandomState(args.seed + 7)))
    entries[4:4] = sh_phase(torch, dev, np.random.RandomState(args.seed + 8))
    entries.insert(6, adam_phase(torch, dev,
                                 np.random.RandomState(args.seed + 9)))

    # -- 9. train parity: one phase-1 gradient, kernels vs plain --------------
    t0 = time.time()
    err = train_parity_phase(torch, dev, config_mod, params_from_numpy,
                             np.random.RandomState(args.seed + 3))
    log(f"[train parity] phase-1 loss and gradients CUDA vs CPU plain at "
        f"64x48: {err} ({time.time() - t0:.1f} s)")

    # -- 10. phase 2: the train CLI past --pbr_iteration, counting launches --
    p2_launches = phase2_phase(torch, dev, ck, timing, work, train_data)

    # -- 11. phase-2 parity: one phase-2 gradient, kernels vs plain ----------
    t0 = time.time()
    err = phase2_parity_phase(torch, dev, config_mod, params_from_numpy,
                              np.random.RandomState(args.seed + 4))
    log(f"[phase-2 parity] phase-2 loss and gradients CUDA vs CPU plain at "
        f"160x48: {err} ({time.time() - t0:.1f} s)")

    # -- 12. the argmax-depth render, counting launches ----------------------
    argmax_launches = argmax_phase(torch, dev, ck, cfg, params, cams)

    # -- 13. the eval CLIs ----------------------------------------------------
    eval_phase(torch, ck, data, model, np.random.RandomState(args.seed + 5),
               args.seed)

    # -- 14. a COLMAP capture: the train CLI through both phases -------------
    colmap_launches = colmap_phase(torch, dev, ck, work, train_data)

    # -- 15. parallel: the tile_base kernels, DP and TS at world size 1 ------
    ranges = tile_range_phase(torch, dev, train_res, train_data, card)
    par_launches = parallel_phase(torch, dev, ck, train_res, work,
                                  train_data, card)
    del train_res

    # -- 17. the quality gate's reduced configs ------------------------------
    gate_launches = quality_phase(torch, dev, ck, card)

    # -- 18. the multi-rank dry run at world size 1 ---------------------------
    dryrun_launches = dryrun_phase(torch, dev, ck)

    # each kernel's launches from the run of the path it serves: the render
    # CLI for the serving kernels, the phase-1 train CLI for composite_bwd,
    # the phase-2 train CLI for gi_march_coherent and patch_bwd, the argmax
    # render for composite_fwd_peak
    for e in entries:
        e["launches"] = (train_launches if e["name"] in TRAINING_KERNELS
                         else p2_launches if e["name"] in PHASE2_KERNELS
                         else argmax_launches if e["name"] in ARGMAX_KERNELS
                         else launches)[e["name"]]
        e["launches_in_training"] = train_launches[e["name"]]
        e["launches_in_phase2"] = p2_launches[e["name"]]
        e["launches_in_argmax_render"] = argmax_launches[e["name"]]
        e["launches_in_colmap_training"] = colmap_launches[e["name"]]
        e["launches_in_parallel_steps"] = par_launches[e["name"]]
        e["launches_in_quality_gate"] = gate_launches[e["name"]]
        e["launches_in_dryrun"] = dryrun_launches[e["name"]]
        if e["name"] in ranges:
            e["tile_ranges"] = ranges[e["name"]]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    table = {"kernels": [dict({k: e[k] for k in keys},
                              **{k: v for k, v in e.items() if k not in keys})
                         for e in entries],
             "tpu_kernels": [{"replaces": f, "function": fn, "status": s}
                             for f, fn, s in TPU_KERNELS],
             "relight": relight, "card": card}
    if not args.workdir:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[done] {time.time() - t_start:.1f} s")
    print(json.dumps(table), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


SERVING_KERNELS = ("expand", "composite_fwd", "gi_march", "patch_fwd",
                   "sh_fwd")
TRAINING_KERNELS = ("composite_bwd", "reduce_instance_grads", "sh_bwd",
                    "adam")
PHASE2_KERNELS = ("gi_march_coherent", "patch_bwd")
ARGMAX_KERNELS = ("composite_fwd_peak",)
# launches of one phase-2 step with --indirect at light_base_res 256
PHASE2_STEP_LAUNCHES = {"expand": 1, "composite_fwd": 1,
                        "composite_fwd_peak": 0, "composite_bwd": 1,
                        "reduce_instance_grads": 1, "gi_march": 0,
                        "gi_march_coherent": 2, "patch_fwd": 3,
                        "patch_bwd": 3, "sh_fwd": 1, "sh_bwd": 1, "adam": 2}


def train_phase(torch, dev, ck, timing, work_dir, rng):
    """The phase-1 train CLI on the card at full width: 8 train views and 2
    test views of 800x800, initialised from the 300k shell points, 30
    steps with a densification and an opacity reset at step 20. A 2-step
    run first takes the per-process warm-up. Returns the launch counts of
    the measured run, its result and the scene directory."""
    from gi_gs_tpu_torch.cli import train_cli
    from gi_gs_tpu_torch.scene.ply import store_point_cloud
    data = os.path.join(work_dir, "train_scene")
    t0 = time.time()
    write_scene(data, rng, 2, SIZE, n_train=N_TRAIN_VIEWS)
    pts = gaussian_fields(rng, N_GAUSSIANS, N_GAUSSIANS)["xyz"]
    store_point_cloud(os.path.join(data, "points3d.ply"), pts,
                      rng.uniform(0, 255, pts.shape))
    log(f"[train scene] {N_TRAIN_VIEWS} train + 2 test views {SIZE}x{SIZE}, "
        f"{N_GAUSSIANS} points, {time.time() - t0:.1f} s")
    flags = ["--source_path", data, "--eval", "--densify_from_iter", "10",
             "--densification_interval", "10", "--opacity_reset_interval",
             "20", "--densify_until_iter", "25"]
    t0 = time.time()
    train_cli.main(flags + ["--model_path", os.path.join(work_dir, "warm"),
                            "--iterations", "2", "--test_iterations", "0",
                            "--save_iterations", "0"])
    log(f"[train warm-up] 2 steps in a fresh model dir: "
        f"{time.time() - t0:.1f} s")

    model = os.path.join(work_dir, "train_model")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launches()
    timing.start()
    t0 = time.time()
    res = train_cli.main(flags + [
        "--model_path", model, "--iterations", str(TRAIN_STEPS),
        "--test_iterations", str(TRAIN_STEPS), "--save_iterations",
        str(TRAIN_STEPS)])
    wall = time.time() - t0
    stages = timing.stop()
    launches = dict(ck.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = res["steps"]
    ms = [1e3 * st["seconds"] for st in steps]
    steady = ms[2:]
    log(f"[train] train_cli.main, {TRAIN_STEPS} phase-1 steps at {SIZE}x"
        f"{SIZE} in {wall:.1f} s (scene load, init, probe, eval and "
        f"checkpoint included); launches {launches}; peak device memory "
        f"{peak:.2f} GiB")
    log("  ms per step (device synchronised): " + ", ".join(
        f"{m:.1f}" for m in ms))
    log(f"  after 2 warm-up steps: mean {np.mean(steady):.2f}, min "
        f"{min(steady):.2f}, max {max(steady):.2f} ms")
    log("  stage ms per step (mean over steps, device synchronised at "
        "stage ends): " + ", ".join(f"{k} {1e3 * v / TRAIN_STEPS:.2f}"
                                   for k, v in stages.items()))
    for r in res["reports"]:
        log(f"  report {r}")
    for k in TRAINING_KERNELS:
        if launches[k] != TRAIN_STEPS:
            fail(f"{k} launched {launches[k]} times in {TRAIN_STEPS} steps")
    missing = [k for k in ("expand", "composite_fwd", "sh_fwd")
               if launches[k] == 0]
    if missing:
        fail(f"the training path launched no {missing}")
    if not all(math.isfinite(st["loss"]) for st in steps):
        fail(f"non-finite training loss {[st['loss'] for st in steps]}")
    for name in (f"chkpnt{TRAIN_STEPS}.pt", f"eval_{TRAIN_STEPS}.json",
                 os.path.join("point_cloud", f"iteration_{TRAIN_STEPS}",
                              "point_cloud.ply")):
        if not os.path.exists(os.path.join(model, name)):
            fail(f"training did not write {name}")
    p = res["state"].params
    alive = p.alive
    # densification at step 20 wrote into slots past the initial points;
    # the opacity reset at step 20 left every opacity near 0.01
    n_new = int(alive[N_GAUSSIANS:].sum())
    max_op = float(torch.sigmoid(p.opacity[alive]).max())
    log(f"  alive {int(alive.sum())} (in slots past the initial points: "
        f"{n_new}), capacity {p.capacity}, max opacity after the reset "
        f"{max_op:.4f}")
    if n_new == 0 or max_op > 0.05:
        fail("no densification or no opacity reset in the training run")
    with open(os.path.join(model, f"eval_{TRAIN_STEPS}.json")) as f:
        log(f"  eval_{TRAIN_STEPS}.json {json.load(f)}")
    profile_steps(torch, dev, res, data, phase2=False)
    return launches, res, data


def profile_steps(torch, dev, res, data, phase2: bool, n: int = 3):
    """Device time by operation over `n` steps of the phase on the trained
    state (one train view, iteration 1: no densification), with
    torch.profiler: the ops with the most device time, and the device's
    busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    from gi_gs_tpu_torch.scene.dataset import load_scene
    from gi_gs_tpu_torch.train import optim, trainer
    cfg = res["cfg"]
    rec = load_scene(data, eval_split=True).train_cameras[0]
    cam = rec.camera(dev)
    image = torch.as_tensor(rec.image, device=dev)
    alpha = torch.as_tensor(rec.alpha, device=dev)
    bg = torch.zeros(3, device=dev)
    tx = optim.build_optimizer(cfg.opt, 1.0)
    step = (trainer.make_phase2_step(cfg, 1.0, tx,
                                     optim.build_light_optimizer(cfg.opt))
            if phase2 else trainer.make_phase1_step(cfg, 1.0, tx))
    state = res["state"]
    state, _ = step(state, cam, image, alpha, bg, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        state, _ = step(state, cam, image, alpha, bg, 1)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=phase2) as prof:
        for _ in range(n):
            state, _ = step(state, cam, image, alpha, bg, 1)
        torch.cuda.synchronize()
    # device-side events only (an op's CPU event also carries the device
    # time of the kernels it launched)
    rows = [(e.key, e.self_device_time_total / 1e3 / n, e.count / n)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(f"[{'phase-2' if phase2 else 'train'} profile] {n} steps: "
        f"{wall:.1f} ms per step unprofiled; "
        f"device busy {busy:.1f} ms per step in the profiled steps "
        f"({100 * busy / wall:.0f}% of the unprofiled step); "
        f"{sum(r[2] for r in rows):.0f} device events per step")
    for key, ms, count in rows[:15]:
        log(f"  {ms:9.3f} ms  x{count:<5.0f} {key[:90]}")
    if not phase2:
        return
    # the light's gather transposes and their gathers, as the profile names
    # their kernels; autograd's index backward must be gone
    groups = {cls: [r for r in rows if any(p in r[0] for p in pats)]
              for cls, pats in TRANSPOSE_KERNELS}
    log("  gather transposes (ms per step, launches per step): " + ", ".join(
        f"{cls} {sum(r[1] for r in g):.3f} x{sum(r[2] for r in g):.0f}"
        for cls, g in groups.items()))
    for key, ms, count in sorted((r for g in groups.values() for r in g),
                                 key=lambda r: -r[1]):
        log(f"    {ms:9.3f} ms  x{count:<5.0f} {key[:100]}")
    # each transpose site apart: the ops that run them, grouped by their
    # input shapes (a site's table rows and gathered rows), with the device
    # time of the kernels each launched
    log("  transpose sites (op, input shapes, calls per step, device ms per "
        "step, bytes bound per step):")
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key in TRANSPOSE_OPS and e.device_time_total > 0:
            b = site_bound_ms(e.key, e.input_shapes)
            log(f"    {e.key} {e.input_shapes} x{e.count / n:.0f} "
                f"{e.device_time_total / 1e3 / n:.3f} ms"
                + ("" if b is None else f", bound {b * e.count / n:.4f} ms"))
    n_index_bwd = sum(r[2] for r in groups["index backward"])
    if n_index_bwd:
        fail(f"{n_index_bwd:.0f} autograd index-backward launches per phase-2 "
             "step (indexing_backward_kernel*)")


# kernel-name patterns of the gather transposes and gathers in a profile
TRANSPOSE_KERNELS = (
    ("index backward", ("indexing_backward_kernel",)),
    ("index_add_", ("indexFunc",)),
    ("cumsum", ("scan_innermost", "scan_outer", "DeviceScan")),
    ("sort", ("radixSort", "RadixSort", "sort_kernel", "segmented_sort",
              "DeviceRadixSort")),
    ("indexing gathers", ("index_elementwise_kernel", "vectorized_gather")))
# the ops of the transposes and their gathers (profile_steps, phase 2)
TRANSPOSE_OPS = ("aten::index_add_", "aten::cumsum", "aten::index_select")


def site_bound_ms(key: str, shapes) -> float:
    """The bytes bound of one call of a transpose op from its input shapes:
    `index_add_` reads its source rows and their ids once and reads and
    writes its table once; `cumsum` reads and writes its input once. None
    for the gathers (their dimension is not in the shapes)."""
    if key == "aten::index_add_":
        (t, c), (n,) = shapes[0], shapes[2]
        return bound(4 * n * c + 8 * n + 8 * t * c, 0)[0]
    if key == "aten::cumsum":
        return bound(8 * math.prod(shapes[0]), 0)[0]
    return None


def composite_bwd_phase(torch, dev, res, data):
    """composite_bwd vs its plain version at the training path's settings:
    the trained state, the train view whose densest tile is the largest,
    the RasterConfig the train CLI ended with (its cap_tile grown past that
    tile), random cotangents. Returns the kernel's entry of the JSON line
    (without `launches`)."""
    from gi_gs_tpu_torch.ops.rasterize import binning, composite
    from gi_gs_tpu_torch.ops.rasterize.preprocess import preprocess
    from gi_gs_tpu_torch.scene.dataset import load_scene
    rc = res["cfg"].raster
    p = res["state"].params
    with torch.no_grad():
        opacity = p.get_opacity()
        cov3d = p.get_covariance()
        best = None
        for rec in load_scene(data, eval_split=True).train_cameras:
            cam = rec.camera(dev)
            H, W = cam.height, cam.width
            pre = preprocess(p.xyz, cov3d, cam.w2c, cam.full_proj,
                             cam.tanfovx, cam.tanfovy, W, H, rc,
                             opacity=opacity)
            b = binning.bin_and_sort(pre, H, W, rc)
            if best is None or int(b.max_tile_count) > best[0]:
                best = (int(b.max_tile_count), cam, pre, b)
        mtc, cam, pre, b = best
        del best
        H, W = cam.height, cam.width
        log(f"[composite_bwd] at the training path's settings: trained "
            f"state ({int(p.alive.sum())} alive), the train view with the "
            f"densest tile ({mtc} instances), cap_tile {rc.cap_tile}, "
            f"cap_instances {rc.cap_instances}")
        if mtc > rc.cap_tile:
            fail(f"the densest tile ({mtc}) is past the train CLI's cap_tile "
                 f"{rc.cap_tile}")
        table = composite.composite_table(
            pre, opacity, p.colors_from_sh(cam.cam_pos), p.get_normal(),
            p.get_albedo(), p.get_roughness(), p.get_metallic())
        grid = rc.grid(H, W)
        ka, kt = composite.composite_fwd(table, b.ids, b.tile_start,
                                         b.tile_count, rc, grid)
        gen = torch.Generator(device=dev).manual_seed(1)
        g_acc = torch.randn(ka.shape, device=dev, generator=gen)
        g_t = torch.randn(kt.shape, device=dev, generator=gen)
        bargs = (table, b.ids, b.tile_start, b.tile_count,
                 ka[:, :4].contiguous(), kt, g_acc, g_t, rc, grid, (H, W))
        k_rows = composite.composite_bwd(*bargs)
        work = {}
        p_rows = composite._composite_bwd_plain(*bargs, work=work)
        if not torch.equal(composite.composite_bwd(*bargs), k_rows):
            fail("composite_bwd: two launches on one input differ")
        log("  composite_bwd: two launches give bit-identical rows")
        torch.cuda.synchronize()
        red = lambda r: composite.reduce_sorted_instance_grads(
            r, b.inv_perm, b.offsets)
        kd, pd = red(k_rows), red(p_rows)
        err = float((kd - pd).abs().max())
        ok = all(torch.allclose(x, y, rtol=2e-4, atol=float(
            2e-5 * (y.abs().amax(dim=0).max() + 1e-3)))
            for x, y in ((k_rows, p_rows), (kd, pd)))
        # the reduction's f32 prefix-sum error against a float64 sum of the
        # same rows per Gaussian (rows outside every tile are 0)
        exact = torch.zeros((p.capacity, composite.TABLE_DIM),
                            dtype=torch.float64, device=dev).index_add_(
            0, b.ids.long(), k_rows.double())
        red_err = float((kd.double() - exact).abs().max())
        red_rel = red_err / float(exact.abs().max())
        cap = b.ids.numel()
        T, P = grid[0] * grid[1], rc.pixels_per_tile
        hist = tile_histogram(b.tile_count)
        log(f"  training view tile_count: {hist}")
        nbytes = (table.numel() * 4 + cap * 4 + T * 8 + T * 22 * P * 4
                  + cap * composite.TABLE_DIM * 4)
        flops, pair_keys = composite_work(work, nbytes, 50.0)
        return kernel_entry(
            "composite_bwd", "gi_gs_tpu_torch/csrc/composite_bwd.cu",
            "gi_gs_tpu/ops/rasterize/pallas_composite.py:455", err, ok,
            "rtol 2e-4, atol 2e-5 x the largest column maximum, on the rows "
            "and the per-Gaussian sums (the JAX test tolerance: the kernel "
            "sums each instance's pixels in warp order and uses the "
            "single-prefix d(alpha) form)",
            kernel_ms(lambda: composite.composite_bwd(*bargs),
                      "composite_bwd", 5),
            cuda_ms(lambda: composite._composite_bwd_plain(*bargs), 1),
            nbytes, flops, **pair_keys, contributing_pairs=work["contrib"],
            cap_tile=rc.cap_tile, max_tile_count=mtc,
            reduction_f32_vs_f64_abs=red_err,
            reduction_f32_vs_f64_rel=red_rel,
            reduction_ms=cuda_ms(lambda: red(k_rows), 5), tile_count=hist,
            resources=log_resources(composite, "composite_bwd", rc, dev))


# Gaussians per segment length (instances per Gaussian) in the compositing
# backward of one garden.train_p1 step of perfbench (seed 2147489101;
# 4,194,304 Gaussians, 6,129,957 instances): (shortest, longest, count)
GARDEN_SEGMENTS = ((1, 1, 3186785), (2, 2, 598443), (3, 4, 317184),
                   (5, 8, 88477), (9, 16, 3323), (17, 32, 90), (33, 64, 1),
                   (129, 256, 1))


def reduce_phase(torch, dev, rng):
    """reduce_instance_grads at the garden shapes: segment lengths drawn
    from GARDEN_SEGMENTS, the capacity the training path would bucket them
    into, a random unsort permutation (the sort by tile scatters a
    Gaussian's instances) and random rows. Fails unless the kernel is
    bit-equal to the plain gather, cumsum and differences on the same rows
    and two launches are bit-identical; logs both times, the byte bound
    and the f32 error against a float64 segment sum."""
    from gi_gs_tpu_torch.ops.rasterize import composite
    from gi_gs_tpu_torch.ops.rasterize.pipeline import bucket_cap_instances
    t0 = time.time()
    seg = np.concatenate([rng.randint(lo, hi + 1, c)
                          for lo, hi, c in GARDEN_SEGMENTS])
    rng.shuffle(seg)
    n, total = seg.size, int(seg.sum())
    cap = bucket_cap_instances(total)
    offsets = torch.as_tensor(np.concatenate([[0], np.cumsum(seg)]).astype(
        np.int32), device=dev)
    gen = torch.Generator(device=dev).manual_seed(int(rng.randint(1 << 30)))
    inv_perm = torch.randperm(cap, device=dev, generator=gen)
    rows = torch.randn((cap, composite.TABLE_DIM), device=dev, generator=gen)
    red = lambda: composite.reduce_sorted_instance_grads(rows, inv_perm,
                                                         offsets)
    plain = lambda: composite._reduce_sorted_instance_grads_plain(
        rows, inv_perm, offsets)
    log(f"[reduce_instance_grads] at the garden shapes: {n} Gaussians, "
        f"{total} instances in capacity {cap}, segments of 1 to "
        f"{int(seg.max())}")
    k = red()
    if not torch.equal(red(), k):
        fail("reduce_instance_grads: two launches on one input differ")
    p = plain()
    err = float((k - p).abs().max())
    equal = torch.equal(k, p)
    log(f"  two launches bit-identical; bit-equal to the plain version: "
        f"{equal}")
    owner = torch.repeat_interleave(torch.arange(n, device=dev),
                                    torch.as_tensor(seg, device=dev))
    exact = torch.zeros((n, composite.TABLE_DIM), dtype=torch.float64,
                        device=dev).index_add_(
        0, owner, rows[inv_perm[:total]].double())
    del owner
    f64 = float((k.double() - exact).abs().max())
    rel = f64 / float(exact.abs().max())
    del exact, k, p
    torch.cuda.empty_cache()
    log(f"  f32 prefix-sum differences vs float64 segment sums: {f64:.3e} "
        f"({rel:.3e} of the largest sum)")
    # each summed row and its inv_perm read once, offsets, the result
    nbytes = (total * (composite.TABLE_DIM * 4 + 8) + (n + 1) * 4
              + n * composite.TABLE_DIM * 4)
    res = composite.kernel_resources("reduce_instance_grads", None, dev)
    log(f"  reduce_instance_grads scan kernel resources: {res}")
    entry = kernel_entry(
        "reduce_instance_grads",
        "gi_gs_tpu_torch/csrc/reduce_instance_grads.cu",
        "none (XLA's gather, cumsum and segment differences, "
        "gi_gs_tpu/ops/rasterize/composite.py:315)", err, equal,
        "bit-equal", kernel_ms(red, "reduce_instance_grads", 20),
        cuda_ms(plain, 3), nbytes, float(total * composite.TABLE_DIM),
        gaussians=n, instances=total, cap_instances=cap,
        f32_vs_f64_abs=f64, f32_vs_f64_rel=rel, resources=res)
    log(f"  ({time.time() - t0:.1f} s)")
    return entry


# bicycle.train_p2's SH layout: 2^23 slots at degree 3, 15 rest rows
SH_SLOTS = 1 << 23
SH_DEG, SH_ROWS = 3, 15


def sh_phase(torch, dev, rng):
    """sh_fwd and sh_bwd at bicycle's shapes (SH_SLOTS slots, degree 3, 15
    rest rows, random coefficients and means around a ring camera, the
    colour's gradient as columns 6:9 of a column-major [N, 21], as the
    compositing backward hands it over) against the plain twin on the same
    tensors: the colour and every gradient bit-equal. Returns the two
    kernels' entries: times, the byte bound, the plain twin's times."""
    from gi_gs_tpu_torch.ops import cuda_kernels as ck
    from gi_gs_tpu_torch.ops import sh
    t0 = time.time()
    n, rows, deg = SH_SLOTS, SH_ROWS, SH_DEG
    gen = torch.Generator(device=dev).manual_seed(int(rng.randint(1 << 30)))
    dc = torch.randn((n, 1, 3), device=dev, generator=gen)
    rest = 0.3 * torch.randn((n, rows, 3), device=dev, generator=gen)
    means = 3.0 * torch.randn((n, 3), device=dev, generator=gen)
    campos = torch.tensor([4.0, 0.5, 1.4], device=dev)
    g = torch.randn((21, n), device=dev, generator=gen).t()[:, 6:9]
    needs = (True, True, True)
    fwd = lambda: sh.sh_fwd(deg, dc, rest, means, campos)
    bwd = lambda: sh.sh_bwd(deg, g, dc, rest, means, campos, needs)
    plain_fwd = lambda: sh._sh_fwd_plain(deg, dc, rest, means, campos)
    log(f"[sh] at bicycle's shapes: {n} slots, degree {deg}, {rows} rest "
        f"rows, the colour's gradient at strides {g.stride()}")
    out, grads = fwd(), bwd()
    if not (torch.equal(fwd(), out) and all(
            torch.equal(a, b) for a, b in zip(bwd(), grads))):
        fail("sh: two launches on one input differ")
    want, saved = plain_fwd()
    ref = sh._sh_bwd_plain(deg, g, saved, needs)
    pairs = list(zip(("colour", "g_dc", "g_rest", "g_means"), (out, *grads),
                     (want, *ref)))
    equal = {k: torch.equal(a, b) for k, a, b in pairs}
    errs = {k: float((a - b).abs().max()) for k, a, b in pairs}
    clamped = float((want == 0).float().mean())
    log(f"  bit-equal to the plain twin: {equal}; largest differences "
        f"{errs}; {clamped:.4f} of the colour channels clamped")
    del out, grads, want, ref, pairs
    plain_bwd = lambda: sh._sh_bwd_plain(deg, g, saved, needs)
    ms_plain = (cuda_ms(plain_fwd, 3), cuda_ms(plain_bwd, 3))
    del saved
    torch.cuda.empty_cache()
    # the kernels' bytes a slot: means, dc, rest in, the colour out; then
    # g, means, dc, rest in, their three gradients out
    fwd_bytes = n * 4 * (3 + 3 + 3 * rows + 3)
    bwd_bytes = n * 4 * (3 + 3 + 3 + 3 * rows + 3 + 3 * rows + 3)
    entries = []
    for name, fn, nbytes, flops, plain_ms, keys in (
            ("sh_fwd", fwd, fwd_bytes, 150.0 * n, ms_plain[0], ("colour",)),
            ("sh_bwd", bwd, bwd_bytes, 400.0 * n, ms_plain[1],
             ("g_dc", "g_rest", "g_means"))):
        res = ck.resources("gigs_sh_resources", dev, int(name == "sh_bwd"),
                           rows)
        log(f"  {name} resources: {res}")
        entries.append(kernel_entry(
            name, "gi_gs_tpu_torch/csrc/sh.cu",
            "none: JAX's sh_to_rgb (gi_gs_tpu/ops/sh.py:74) is XLA",
            max(errs[k] for k in keys), all(equal[k] for k in keys),
            "bit-equal", kernel_ms(fn, name, 20), plain_ms, nbytes, flops,
            slots=n, degree=deg, rest_rows=rows, resources=res))
    log(f"  ({time.time() - t0:.1f} s)")
    return entries


def adam_phase(torch, dev, rng):
    """The adam kernel at bicycle's shapes: the Gaussians' ten groups over
    SH_SLOTS slots (one launch) and the light's cubemap (another), from
    step 30,001 (the BRDF's schedule at its offset), random parameters,
    gradients and moments, against the plain chain (optim.adam_step) on
    the same tensors: p, mu and nu bit-equal in every group. Returns the
    kernel's entry: the Gaussians' launch time, the byte bound (28 B an
    element), the chain's time over the same groups, the light's launch
    time besides."""
    from gi_gs_tpu_torch.config import OptimizationConfig
    from gi_gs_tpu_torch.ops import cuda_kernels as ck
    from gi_gs_tpu_torch.train import optim
    t0 = time.time()
    n, count = SH_SLOTS, 30_001
    gen = torch.Generator(device=dev).manual_seed(int(rng.randint(1 << 30)))
    opt = OptimizationConfig()
    # the trained fields at SH degree 3, 67 floats a slot
    slot = {k: v.shape[1:] for k, v in gaussian_fields(rng, 1, 1).items()
            if k in optim.TRAINABLE_FIELDS}
    sets = {"gaussians": (optim.build_optimizer(opt, 4.0),
                          {f: (n,) + s for f, s in slot.items()}),
            "light": (optim.build_light_optimizer(opt),
                      {"cubemap": (6, LIGHT_RES, LIGHT_RES, 3)})}
    log(f"[adam] at bicycle's shapes: {n} slots x "
        f"{sum(math.prod(s) for s in slot.values())} floats in "
        f"{len(slot)} groups, and the {LIGHT_RES}^2 cubemap; step {count}")
    ms, elements, equal, errs, plain_ms = {}, {}, {}, {}, 0.0
    for name, (tx, shapes) in sets.items():
        rand = lambda shape, scale: scale * torch.randn(
            shape, device=dev, generator=gen)
        view = {f: rand(s, 1.0) for f, s in shapes.items()}
        grads = {f: rand(s, 1e-3) for f, s in shapes.items()}
        state = {optim.GROUP_OF_FIELD.get(f, f): {
            "mu": rand(s, 1e-3), "nu": rand(s, 1e-3) ** 2,
            "count": count - 1} for f, s in shapes.items()}
        step = lambda: tx.step(grads, state, view)
        chain = lambda: {f: optim.adam_step(
            p, grads[f], state[optim.GROUP_OF_FIELD.get(f, f)],
            tx.lrs[optim.GROUP_OF_FIELD.get(f, f)]) for f, p in view.items()}
        new_view, new_state = step()
        for f, (p, st) in chain().items():
            grp = optim.GROUP_OF_FIELD.get(f, f)
            for what, a, b in (("p", new_view[f], p),
                               ("mu", new_state[grp]["mu"], st["mu"]),
                               ("nu", new_state[grp]["nu"], st["nu"])):
                equal[f"{f}.{what}"] = torch.equal(a, b)
                errs[f"{f}.{what}"] = float((a - b).abs().max())
        del new_view, new_state
        elements[name] = sum(p.numel() for p in view.values())
        ms[name] = kernel_ms(step, "adam", 10)
        if name == "gaussians":
            plain_ms = cuda_ms(chain, 3)
        del view, grads, state
        torch.cuda.empty_cache()
    bad = sorted(k for k, v in equal.items() if not v)
    log(f"  bit-equal to the plain chain in p, mu and nu of every group: "
        f"{not bad}{'; differ: ' + str(bad) if bad else ''}")
    res = ck.resources("gigs_adam_resources", dev)
    log(f"  adam resources: {res}; the light's launch "
        f"({elements['light']} floats) {ms['light']:.3f} ms")
    entry = kernel_entry(
        "adam", "gi_gs_tpu_torch/csrc/adam.cu",
        "none: optax's scale_by_adam and the groups' rates "
        "(gi_gs_tpu/train/optim.py) are XLA", max(errs.values()), not bad,
        "bit-equal", ms["gaussians"], plain_ms, 28.0 * elements["gaussians"],
        10.0 * elements["gaussians"], slots=n, elements=elements["gaussians"],
        light_elements=elements["light"], light_ms=ms["light"],
        light_bound_ms=28.0 * elements["light"] / HBM_BYTES_PER_S * 1e3,
        resources=res)
    log(f"  ({time.time() - t0:.1f} s)")
    return entry


def train_parity_phase(torch, dev, config_mod, params_from_numpy, rng):
    """trainer.loss_and_grads with CUDA tensors (the kernels) against the
    same state on the CPU (the plain versions) at 64x48, default raster
    config. Tolerance: loss to 1e-5 relative; every gradient (live slots,
    and ndc_grad) within rtol 2e-4, atol 2e-5 x the field's largest
    magnitude, as tests/test_torch_composite_bwd.py."""
    from gi_gs_tpu_torch.scene.cameras import make_camera
    from gi_gs_tpu_torch.train import trainer
    n, cap = 3000, 4096
    fields = gaussian_fields(rng, n, cap)
    d = fields["xyz"][:n] / np.linalg.norm(fields["xyz"][:n], axis=1,
                                            keepdims=True)
    fields["xyz"][:n] = d * 0.8
    fields["scaling"][:n] = rng.uniform(-4.0, -2.8, (n, 3))
    ys, xs = np.mgrid[0:48, 0:64] / 64
    img = np.stack([0.5 + 0.4 * np.sin(5 * xs + 3 * ys + p)
                    for p in rng.uniform(0, 6, 3)]).astype(np.float32)
    alpha = (np.hypot(xs - 0.5, ys - 0.37) < 0.3)[None].astype(np.float32)
    cfg = config_mod.Config()
    outs = []
    for device in (dev, torch.device("cpu")):
        params = params_from_numpy(fields, 3, 3, device=device)
        cam = make_camera(np.eye(3), np.array([0.0, 0.0, 3.0]), 0.9, 0.7, 64,
                          48, device=device)
        t = lambda a: torch.as_tensor(a, device=device)
        loss, aux, grads, ndc = trainer.loss_and_grads(
            cfg, params, cam, t(img), t(alpha), t(np.array([0.1, 0.2, 0.3],
                                                           np.float32)))
        grads["ndc"] = ndc
        outs.append((float(loss), {k: v.cpu() for k, v in grads.items()}))
    (lk, gk), (lp, gp) = outs
    if abs(lk - lp) > 1e-5 * abs(lp):
        fail(f"train parity: loss {lk} vs {lp}")
    alive = torch.as_tensor(fields["alive"])
    worst = {}
    for k in gk:
        a, b = gk[k][alive], gp[k][alive]
        scale = float(b.abs().max())
        worst[k] = float((a - b).abs().max()) / max(scale, 1e-30)
        if not torch.allclose(a, b, rtol=2e-4, atol=2e-5 * scale):
            fail(f"train parity: gradient of {k} differs by "
                 f"{float((a - b).abs().max())} (largest {scale})")
    k = max(worst, key=worst.get)
    return (f"loss {lk:.6f} vs {lp:.6f}; worst gradient {k} "
            f"{worst[k]:.2e} of its largest")


def phase2_phase(torch, dev, ck, timing, work_dir, data):
    """The train CLI past --pbr_iteration on the card: phase 7's final
    checkpoint (iteration 30) trains PHASE2_STEPS deferred-PBR steps with
    --indirect at 800x800, light_base_res 256, then evaluates the PBR view
    on the 2 test views. Launch counts are set to 0 just before the run
    and read around every step (the step factory is wrapped), so each
    step's launches are checked apart from the probe and the eval. Returns
    the launch counts of the whole run."""
    from gi_gs_tpu_torch.cli import train_cli
    from gi_gs_tpu_torch.train import trainer
    start = os.path.join(work_dir, "train_model", f"chkpnt{TRAIN_STEPS}.pt")
    last = TRAIN_STEPS + PHASE2_STEPS
    model = os.path.join(work_dir, "phase2_model")
    per_step = []
    make = trainer.make_phase2_step

    def counted_factory(*a, **kw):
        step = make(*a, **kw)

        def counted(*sa, **skw):
            before = dict(ck.launches)
            out = step(*sa, **skw)
            per_step.append({k: ck.launches[k] - before[k] for k in before})
            return out
        counted.light_tables = step.light_tables
        return counted

    trainer.make_phase2_step = counted_factory
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launches()
    timing.start()
    t0 = time.time()
    try:
        res = train_cli.main([
            "--source_path", data, "--eval", "--model_path", model,
            "--start_checkpoint", start, "--pbr_iteration", str(TRAIN_STEPS),
            "--iterations", str(last), "--indirect",
            "--light_base_res", str(LIGHT_RES), "--test_iterations",
            str(last), "--save_iterations", str(last)])
    finally:
        trainer.make_phase2_step = make
    wall = time.time() - t0
    stages = timing.stop()
    launches = dict(ck.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = res["steps"]
    ms = [1e3 * st["seconds"] for st in steps]
    steady = ms[2:]
    log(f"[phase 2] train_cli.main from chkpnt{TRAIN_STEPS}.pt, "
        f"{PHASE2_STEPS} phase-2 steps (--indirect, light_base_res "
        f"{LIGHT_RES}) at {SIZE}x{SIZE} in {wall:.1f} s (scene load, probe, "
        f"prefilter tables, eval and checkpoint included); launches "
        f"{launches}; peak device memory {peak:.2f} GiB")
    log("  ms per step (device synchronised): " + ", ".join(
        f"{m:.1f}" for m in ms))
    log(f"  after 2 warm-up steps: mean {np.mean(steady):.2f}, min "
        f"{min(steady):.2f}, max {max(steady):.2f} ms")
    log("  stage ms per step (mean over steps, device synchronised at "
        "stage ends): " + ", ".join(f"{k} {1e3 * v / PHASE2_STEPS:.2f}"
                                   for k, v in stages.items()))
    if [st["phase"] for st in steps] != [2] * PHASE2_STEPS:
        fail(f"the run did not take {PHASE2_STEPS} phase-2 steps")
    if len(per_step) != PHASE2_STEPS:
        fail(f"{len(per_step)} counted phase-2 steps")
    for i, got in enumerate(per_step):
        want = {k: PHASE2_STEP_LAUNCHES[k] for k in got}
        if got != want:
            fail(f"phase-2 step {i + 1} launched {got}, expected {want}")
    log(f"  launches per phase-2 step, every step: {per_step[0]}")
    outside = {k: launches[k] - sum(st[k] for st in per_step)
               for k in launches}
    log(f"  launches outside the steps (probe and eval): {outside}")
    if launches["gi_march"]:
        fail("the phase-2 run launched the exact march")
    if not all(math.isfinite(st["loss"]) for st in steps):
        fail(f"non-finite phase-2 loss {[st['loss'] for st in steps]}")
    cube = res["state"].cubemap
    cmin = float(cube.min())
    log(f"  cubemap min {cmin:.6f}, max {float(cube.max()):.4f}, finite "
        f"{bool(torch.isfinite(cube).all())}; losses "
        f"{[round(st['loss'], 5) for st in steps]}")
    if cmin < 0 or not bool(torch.isfinite(cube).all()):
        fail("the cubemap went negative or non-finite")
    for name in (f"chkpnt{last}.pt", f"eval_{last}.json"):
        if not os.path.exists(os.path.join(model, name)):
            fail(f"phase-2 training did not write {name}")
    with open(os.path.join(model, f"eval_{last}.json")) as f:
        metrics = json.load(f)
    log(f"  eval_{last}.json (PBR view) {metrics}")
    if not math.isfinite(metrics["psnr"]):
        fail("non-finite phase-2 eval")
    profile_steps(torch, dev, res, data, phase2=True)
    return launches


def phase2_parity_phase(torch, dev, config_mod, params_from_numpy, rng):
    """trainer.phase2_loss_and_grads with CUDA tensors (the kernels)
    against the same inputs on the CPU (the plain versions) at 160x48,
    default GIParams (the coherent march), --indirect, light_base_res 64.
    Tolerance: loss to 1e-4 relative; every gradient (live slots, ndc, the
    cubemap) within 1e-3 of the field's largest magnitude: the two
    compositing orders may put a z-buffer value one ulp apart, which can
    flip one ray's hit test (one direction weight, <= 0.0031 of a pixel's
    occlusion or indirect light)."""
    from gi_gs_tpu_torch.models import light as light_mod
    from gi_gs_tpu_torch.scene.cameras import compute_view_dirs, make_camera
    from gi_gs_tpu_torch.train import trainer
    n, cap, W, H = 6000, 8192, 160, 48
    fields = gaussian_fields(rng, n, cap)
    d = fields["xyz"][:n] / np.linalg.norm(fields["xyz"][:n], axis=1,
                                            keepdims=True)
    fields["xyz"][:n] = d * 0.8
    fields["scaling"][:n] = rng.uniform(-4.0, -2.8, (n, 3))
    ys, xs = np.mgrid[0:H, 0:W] / W
    img = np.stack([0.5 + 0.4 * np.sin(5 * xs + 3 * ys + p)
                    for p in rng.uniform(0, 6, 3)]).astype(np.float32)
    alpha = (np.hypot(xs - 0.5, (ys - 0.15) * 0.5) < 0.3)[None].astype(
        np.float32)
    cub = random_cubemap(rng, 64)
    cfg = config_mod.Config()
    cfg.train.light_base_res = 64
    cfg.train.indirect = True
    outs = []
    for device in (dev, torch.device("cpu")):
        params = params_from_numpy(fields, 3, 3, device=device)
        cam = make_camera(np.eye(3), np.array([0.0, 0.0, 3.0]), 1.6, 0.5, W,
                          H, device=device)
        t = lambda a: torch.as_tensor(a, device=device)
        tables = light_mod.build_prefilter_tables(64, device=device)
        loss, _, grads, ndc, lg = trainer.phase2_loss_and_grads(
            cfg, tables, params, t(cub), cam, t(img), t(alpha),
            torch.zeros(3, device=device), compute_view_dirs(cam))
        grads = dict(grads, ndc=ndc)
        outs.append((float(loss), {k: v.cpu() for k, v in grads.items()},
                     lg.cpu()))
    (lk, gk, ck_), (lp, gp, cp) = outs
    if abs(lk - lp) > 1e-4 * abs(lp):
        fail(f"phase-2 parity: loss {lk} vs {lp}")
    alive = torch.as_tensor(fields["alive"])
    pairs = {k: (gk[k][alive], gp[k][alive]) for k in gk}
    pairs["cubemap"] = (ck_, cp)
    worst = {}
    for k, (a, b) in pairs.items():
        scale = float(b.abs().max())
        diff = float((a - b).abs().max())
        worst[k] = diff / max(scale, 1e-30)
        if not bool(torch.isfinite(a).all()) or diff > 1e-3 * scale:
            fail(f"phase-2 parity: gradient of {k} differs by {diff} "
                 f"(largest {scale})")
    if float(cp.abs().max()) == 0 or float(gp["albedo"].abs().max()) == 0:
        fail("phase-2 parity: no gradient reached the cubemap or albedo")
    k = max(worst, key=worst.get)
    return (f"loss {lk:.6f} vs {lp:.6f}; worst gradient {k} "
            f"{worst[k]:.2e} of its largest; "
            + ", ".join(f"{k} {v:.1e}" for k, v in worst.items()))


def argmax_phase(torch, dev, ck, cfg, params, cams):
    """`renderer.render(..., inference=True, argmax_depth=True)` over the
    test views under inference mode, launch counts read around each view:
    composite_fwd_peak once, composite_fwd never. Every output finite;
    every covered peak depth inside the depth range of the view's visible
    Gaussians. Returns the launch counts of the run."""
    from gi_gs_tpu_torch.ops.rasterize.preprocess import preprocess
    from gi_gs_tpu_torch.renderer import render
    gi = cfg.gi._replace(backend="pallas_exact")       # the eval CLIs' march
    bg = torch.zeros(3, device=dev)

    def view(cam):
        with torch.inference_mode():
            return render(cam, params, bg, cfg.raster, gi, inference=True,
                          argmax_depth=True)
    view(cams[0])
    torch.cuda.synchronize()
    ck.reset_launches()
    ms = []
    for i, cam in enumerate(cams):
        before = dict(ck.launches)
        t0 = time.perf_counter()
        res = view(cam)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        got = {k: ck.launches[k] - before[k]
               for k in ("composite_fwd_peak", "composite_fwd")}
        if got != {"composite_fwd_peak": 1, "composite_fwd": 0}:
            fail(f"argmax render of view {i} launched {got}")
        for key, v in res.items():
            if v.dtype.is_floating_point and not bool(torch.isfinite(v).all()):
                fail(f"argmax render: non-finite {key}")
        with torch.inference_mode():
            pre = preprocess(params.xyz, params.get_covariance(), cam.w2c,
                             cam.full_proj, cam.tanfovx, cam.tanfovy,
                             cam.width, cam.height, cfg.raster,
                             opacity=params.get_opacity())
        vis = pre.radius > 0
        lo, hi = float(pre.depth[vis].min()), float(pre.depth[vis].max())
        d = res["depth_map"][res["opacity_map"] > 1e-6]
        if d.numel() == 0 or float(d.min()) < lo or float(d.max()) > hi:
            fail(f"argmax render of view {i}: covered peak depths "
                 f"[{float(d.min())}, {float(d.max())}] outside the visible "
                 f"Gaussians' [{lo}, {hi}]")
        log(f"[argmax] view {i}: {d.numel()} covered pixels, peak depth "
            f"{float(d.min()):.4f}..{float(d.max()):.4f} inside the visible "
            f"Gaussians' {lo:.4f}..{hi:.4f}")
    launches = dict(ck.launches)
    log(f"[argmax] renderer.render(argmax_depth=True) over {len(cams)} views "
        f"{SIZE}x{SIZE}: launches {launches}; ms per view (device "
        f"synchronised): " + ", ".join(f"{m:.1f}" for m in ms))
    return launches


def write_flat_hdr(path: str, rng: np.random.RandomState, h: int = 512,
                   w: int = 1024) -> np.ndarray:
    """A synthetic sky as a Radiance .hdr of flat RGBE scanlines, encoded
    with numpy; returns what a decoder must give, mantissa * 2^(e - 136)."""
    v, u = np.mgrid[0:h, 0:w] / np.array([h, w], np.float64)[:, None, None]
    sky = np.stack([0.3 + 2.0 * np.exp(-((u - 0.3) ** 2 + (v - 0.25) ** 2)
                                       / 0.01) * c + 0.5 * (1 - v)
                    for c in (1.0, 0.9, 0.7)], -1)
    sky *= rng.uniform(0.95, 1.05, sky.shape)
    m = sky.max(-1)
    mant, ex = np.frexp(m)
    rgbe = np.empty((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(sky * (mant * 256.0 / m)[..., None], 0, 255)
    rgbe[..., 3] = ex + 128
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
    scale = np.ldexp(1.0, rgbe[..., 3].astype(np.int32) - 136).astype(
        np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def check_json(path: str) -> dict:
    """Load a metrics JSON and fail unless every number in it is finite."""
    if not os.path.exists(path):
        fail(f"{path} was not written")
    with open(path) as f:
        data = json.load(f)

    def numbers(x):
        if isinstance(x, dict):
            return [n for v in x.values() for n in numbers(v)]
        if isinstance(x, list):
            return [n for v in x for n in numbers(v)]
        return [x] if isinstance(x, (int, float)) else []
    if not all(math.isfinite(n) for n in numbers(data)):
        fail(f"non-finite value in {path}: {data}")
    return data


def eval_phase(torch, ck, data, model, rng, seed):
    """The eval CLIs on the serving scene: `render_cli --brdf_eval
    --lpips_weights` at 800x800 (GT albedo PNGs and random LPIPS weights
    written here), `relight_cli` under a synthetic 512x1024 .hdr at
    --resolution 2 with --cubemap_res 256, then `relight_eval_cli` and
    `normal_eval_cli` on the files renamed as the fork's batch scripts do,
    and `collect_cli` over the model directory. Every JSON must be written
    and finite."""
    from gi_gs_tpu_torch.cli import (collect_cli, normal_eval_cli,
                                     relight_cli, relight_eval_cli,
                                     render_cli)
    from gi_gs_tpu_torch.models import light as light_mod
    from gi_gs_tpu_torch.ops import cubemap as cm
    from gi_gs_tpu_torch.utils import lpips as lpips_mod
    from gi_gs_tpu_torch.utils.image_io import read_png, write_png
    work = os.path.dirname(model)
    ys, xs = np.mgrid[0:SIZE, 0:SIZE] / SIZE
    for i in range(N_VIEWS):
        alb = np.stack([0.5 + 0.3 * np.sin(5 * xs + 3 * ys + i + c)
                        for c in range(3)], -1)
        write_png(os.path.join(data, "test", f"r_{i}_albedo.png"),
                  (alb * 255).astype(np.uint8))
    npz = os.path.join(work, "lpips_random.npz")
    np.savez(npz, **lpips_mod.random_lpips_weights(seed))
    hdr = os.path.join(work, "synthetic_sky.hdr")
    want = write_flat_hdr(hdr, rng)
    img, backend = light_mod.decode_hdr(hdr)
    err = float(np.abs(img - want).max())
    log(f"[eval] {hdr.rsplit(os.sep, 1)[-1]} {img.shape} decoded by "
        f"{backend}; max |decoded - encoded| {err}")
    if err > (0.0 if backend == "built-in" else 1e-3 * float(want.max())):
        fail(f"the .hdr decoded by {backend} differs from its RGBE values")

    # render CLI: NVS + albedo eval + LPIPS
    ck.reset_launches()
    t0 = time.time()
    res = render_cli.main(["--model_path", model, "--source_path", data,
                           "--brdf_eval", "--lpips_weights", npz])
    nvs = check_json(os.path.join(model, "test", "ours_1", "pbr",
                                  "NVS.json"))
    for k in ("psnr_avg", "ssim_avg", "lpips_avg", "albedo_psnr",
              "albedo_ssim"):
        if not isinstance(nvs.get(k), float):
            fail(f"NVS.json has no finite {k}: {nvs}")
    check_json(os.path.join(model, "test", "ours_1", "albedo",
                            "albedo_ratio.json"))
    log(f"[eval] render_cli --brdf_eval --lpips_weights over {N_VIEWS} views "
        f"{SIZE}x{SIZE} in {time.time() - t0:.1f} s; launches "
        f"{dict(ck.launches)}; NVS.json {nvs}")
    for key, what in (("view_seconds", "PBR view"),
                      ("albedo_seconds", "albedo eval render"),
                      ("lpips_seconds", "LPIPS (VGG16, f32)")):
        log(f"  ms per view, {what}: " + ", ".join(
            f"{1e3 * t:.1f}" for t in res[key]))

    # relighting at 400x400 under the synthetic sky
    info0 = cm._patch_tables.cache_info()
    ck.reset_launches()
    t0 = time.time()
    rel = relight_cli.main(["--model_path", model, "--source_path", data,
                            "--hdri", hdr, "--resolution", "2",
                            "--cubemap_res", str(LIGHT_RES)])
    wall = time.time() - t0
    info1 = cm._patch_tables.cache_info()
    launches = dict(ck.launches)
    hits, misses = info1.hits - info0.hits, info1.misses - info0.misses
    log(f"[eval] relight_cli over {len(rel['names'])} views at "
        f"{SIZE // 2}x{SIZE // 2}, cubemap {LIGHT_RES}^2, in {wall:.1f} s; "
        f"prefilter host tables "
        + ("built" if misses else "reused from this process's cache" if hits
           else "not needed: the tables kept on the card")
        + f" ({hits} hits, {misses} misses); launches {launches}")
    log("  ms per relit view (device synchronised): " + ", ".join(
        f"{1e3 * t:.1f}" for t in rel["view_seconds"]))
    missing = [k for k in ("expand", "composite_fwd", "gi_march", "patch_fwd")
               if launches[k] == 0]
    if missing or launches["composite_fwd_peak"]:
        fail(f"relighting launched {launches}")
    for name in rel["names"] + ["envmap"]:
        shape = read_png(os.path.join(rel["out_dir"], f"{name}.png")).shape
        if name != "envmap" and shape[:2] != (SIZE // 2, SIZE // 2):
            fail(f"relit {name} is {shape}")

    # relight metrics on the files renamed as relight_eval_cli reads them
    env, dataset = "synthetic_sky", "synthetic"
    pred_dir = os.path.join(work, "relight_pred")
    gt_dir = os.path.join(work, "relight_gt")
    os.makedirs(pred_dir)
    os.makedirs(os.path.join(gt_dir, dataset, env))
    for i, name in enumerate(rel["names"]):
        fid = 10 * (i + 1)
        shutil.copy(os.path.join(rel["out_dir"], f"{name}.png"),
                    os.path.join(pred_dir, f"r_{fid:04}_{env}.png"))
        shutil.copy(os.path.join(data, "test", f"{name}.png"),
                    os.path.join(gt_dir, dataset, env, f"r_{fid:04}.png"))
    saved_env = {k: os.environ.get(k)
                 for k in ("DATA_SUBDIR", "MAP_NAME", "DATASET")}
    cwd = os.getcwd()
    os.environ.update(DATA_SUBDIR="train", MAP_NAME=env, DATASET=dataset)
    os.chdir(work)               # relight_eval_cli writes under ./relight
    try:
        m = relight_eval_cli.main(["--output_dir", pred_dir, "--gt_dir",
                                   gt_dir, "--num_test", str(N_VIEWS),
                                   "--size", str(SIZE // 2),
                                   "--lpips_weights", npz])
        m_path = os.path.join(work, m["path"])
    finally:
        os.chdir(cwd)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    relit = check_json(m_path)
    if m["n"] != N_VIEWS or relit["lpips_avg"] is None:
        fail(f"relight_eval_cli compared {m['n']} pairs: {relit}")

    # normal MAE on the files renamed as normal_eval_cli reads them; the GT
    # is the rendered normal map under the frame's alpha
    ne_out, ne_gt = (os.path.join(work, d) for d in ("normal_eval",
                                                     "normal_gt"))
    os.makedirs(os.path.join(ne_out, "normal"))
    src = os.path.join(model, "test", "ours_1", "normal")
    for i in range(N_VIEWS):
        for suffix in ("normal", "from_depth"):
            shutil.copy(os.path.join(src, f"r_{i}_{suffix}.png"),
                        os.path.join(ne_out, "normal", f"{i:05d}_{suffix}.png"))
        rgb = read_png(os.path.join(src, f"r_{i}_normal.png"))[..., :3]
        alpha = read_png(os.path.join(data, "test", f"r_{i}.png"))[..., 3:]
        os.makedirs(os.path.join(ne_gt, f"test_{i:03d}"))
        write_png(os.path.join(ne_gt, f"test_{i:03d}", "normal.png"),
                  np.concatenate([rgb, alpha], -1))
    normal_eval_cli.main(["--output_dir", ne_out, "--gt_dir", ne_gt])
    mae = check_json(os.path.join(ne_out, "normal_mae.json"))

    summary_path = os.path.join(work, "summary.json")
    collect_cli.main(["--base", model, "--out", summary_path])
    summary = check_json(summary_path)
    if "psnr_avg" not in summary:
        fail(f"collect_cli found no psnr_avg: {summary}")
    log(f"[eval] relight metrics {relit}; normal MAE {mae}; collect_cli "
        f"summary {summary}")


def colmap_phase(torch, dev, ck, work_dir, train_data):
    """Phase 7's scene as a COLMAP capture: its 10 poses at 800x800 with a
    PINHOLE camera of lego's camera_angle_x, its RGB frames as PNGs and its
    300,000 shell points as a binary sparse/0. `load_scene` must read it
    through the native reader and give the Blender form's world-view and
    projection matrices (1e-5) and the shell's points. Then the train CLI
    trains it COLMAP_P1_STEPS phase-1 steps and COLMAP_P2_STEPS phase-2
    steps (--indirect, light_base_res 256), launch counts set to 0 just
    before and read after: every training kernel must launch, the exact
    march not. Returns the launch counts."""
    from gi_gs_tpu_torch import native
    from gi_gs_tpu_torch.cli import train_cli
    from gi_gs_tpu_torch.scene.dataset import load_scene
    from gi_gs_tpu_torch.scene.ply import fetch_point_cloud
    data = os.path.join(work_dir, "colmap_scene")
    t0 = time.time()
    shell, colors, _ = fetch_point_cloud(os.path.join(train_data,
                                                      "points3d.ply"))
    blender_to_colmap(train_data, data, shell.astype(np.float64),
                      np.round(colors * 255).astype(np.int64))
    t_write = time.time() - t0
    native.reads.clear()
    t0 = time.time()
    scene = load_scene(data, images="images", eval_split=True,
                       resolution=-1, white_background=False,
                       max_cameras=None)
    t_load = time.time() - t0
    if native.get() is None or dict(native.reads) != {"images.bin": 1,
                                                      "points3D.bin": 1}:
        fail(f"the COLMAP scene was not read by the native reader "
             f"(reads {dict(native.reads)})")
    recs = scene.train_cameras + scene.test_cameras
    blender = load_scene(train_data, eval_split=True)
    colmap_recs = {r.name: r for r in recs}
    worst = 0.0
    for split, brecs in (("train", blender.train_cameras),
                         ("test", blender.test_cameras)):
        for r in brecs:
            a, b = r.camera(dev), colmap_recs[f"{split}_{r.name}"].camera(dev)
            worst = max(worst, float((a.w2c - b.w2c).abs().max()),
                        float((a.full_proj - b.full_proj).abs().max()))
    if len(recs) != 10 or worst > 1e-5:
        fail(f"COLMAP cameras: {len(recs)} views, world-view / projection "
             f"off the Blender form's by {worst}")
    if not np.array_equal(scene.points, shell):
        fail("the COLMAP points are not the shell's")
    log(f"[colmap] phase 7's scene as a binary sparse/0 ({len(recs)} views "
        f"{recs[0].width}x{recs[0].height}, {len(scene.points)} points) "
        f"written in {t_write:.1f} s, loaded in {t_load:.1f} s through the "
        f"native reader ({native.get().__file__}); cameras within {worst:.2e} "
        f"of the Blender form's, {len(scene.train_cameras)} train / "
        f"{len(scene.test_cameras)} test views (llffhold 8)")
    model = os.path.join(work_dir, "colmap_model")
    last = COLMAP_P1_STEPS + COLMAP_P2_STEPS
    ck.reset_launches()
    t0 = time.time()
    res = train_cli.main([
        "--source_path", data, "--model_path", model, "--eval",
        "--iterations", str(last), "--pbr_iteration", str(COLMAP_P1_STEPS),
        "--indirect", "--light_base_res", str(LIGHT_RES),
        "--test_iterations", str(last), "--save_iterations", str(last)])
    wall = time.time() - t0
    launches = dict(ck.launches)
    steps = res["steps"]
    if [st["phase"] for st in steps] != [1] * COLMAP_P1_STEPS + \
            [2] * COLMAP_P2_STEPS:
        fail(f"the COLMAP run took phases {[st['phase'] for st in steps]}")
    if not all(math.isfinite(st["loss"]) for st in steps):
        fail(f"non-finite COLMAP training loss {[st['loss'] for st in steps]}")
    ms = [1e3 * st["seconds"] for st in steps]
    p1, p2 = ms[1:COLMAP_P1_STEPS], ms[COLMAP_P1_STEPS + 1:]
    log(f"[colmap] train_cli.main, {COLMAP_P1_STEPS} phase-1 + "
        f"{COLMAP_P2_STEPS} phase-2 steps (--indirect, light_base_res "
        f"{LIGHT_RES}) in {wall:.1f} s (scene load, init, eval and checkpoint "
        f"included); launches {launches}")
    log("  ms per step (device synchronised): " + ", ".join(
        f"{m:.1f}" for m in ms))
    log(f"  after each phase's first step: phase 1 mean {np.mean(p1):.2f} "
        f"ms, phase 2 mean {np.mean(p2):.2f} ms")
    missing = [k for k in ("expand", "composite_fwd", "composite_bwd",
                           "gi_march_coherent", "patch_fwd", "patch_bwd")
               if launches[k] == 0]
    if missing or launches["gi_march"]:
        fail(f"the COLMAP training run launched no {missing} or the exact "
             f"march ({launches})")
    for name in (f"chkpnt{last}.pt", f"eval_{last}.json"):
        if not os.path.exists(os.path.join(model, name)):
            fail(f"COLMAP training did not write {name}")
    with open(os.path.join(model, f"eval_{last}.json")) as f:
        metrics = json.load(f)
    log(f"  eval_{last}.json (PBR view) {metrics}")
    if not math.isfinite(metrics["psnr"]):
        fail("non-finite COLMAP eval")
    return launches


def tile_range_phase(torch, dev, res, data, card):
    """Phase 15 (a): composite_fwd and composite_bwd over TILE_RANGES
    contiguous tile ranges (`tile_base`, the ranges of
    pipeline._composite_local_tiles at TILE_RANGES ranks) of phase 7's
    trained state on train view 0 at the train CLI's final RasterConfig,
    against the whole-image launch (bit-equal) and against the plain
    versions. Returns {kernel: its tile-range keys of the JSON line}."""
    from gi_gs_tpu_torch.ops.rasterize import binning, composite
    from gi_gs_tpu_torch.ops.rasterize.preprocess import preprocess
    from gi_gs_tpu_torch.scene.dataset import load_scene
    rc = res["cfg"].raster
    p = res["state"].params
    cam = load_scene(data, eval_split=True).train_cameras[0].camera(dev)
    H, W = cam.height, cam.width
    with torch.no_grad():
        opacity = p.get_opacity()
        pre = preprocess(p.xyz, p.get_covariance(), cam.w2c, cam.full_proj,
                         cam.tanfovx, cam.tanfovy, W, H, rc, opacity=opacity)
        b = binning.bin_and_sort(pre, H, W, rc)
        table = composite.composite_table(
            pre, opacity, p.colors_from_sh(cam.cam_pos), p.get_normal(),
            p.get_albedo(), p.get_roughness(), p.get_metallic())
        grid = rc.grid(H, W)
        T = grid[0] * grid[1]
        t_local = -(-T // TILE_RANGES)
        pad = TILE_RANGES * t_local - T
        fargs = (table, b.ids, b.tile_start, b.tile_count, rc, grid)
        acc, fin = composite.composite_fwd(*fargs)
        gen = torch.Generator(device=dev).manual_seed(2)
        g_acc = torch.randn(acc.shape, device=dev, generator=gen)
        g_t = torch.randn(fin.shape, device=dev, generator=gen)
        bargs = (table, b.ids, b.tile_start, b.tile_count,
                 acc[:, :4].contiguous(), fin, g_acc, g_t, rc, grid, (H, W))
        rows = composite.composite_bwd(*bargs)
        padded = lambda x: torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
        ts, tc, ga, gt = map(padded, (b.tile_start, b.tile_count, g_acc,
                                      g_t))
        log(f"[tile ranges] phase 7's state on train view 0 ({W}x{H}), tile "
            f"{rc.tile_h}x{rc.tile_w}, grid {grid[0]} x {grid[1]} = {T} "
            f"tiles as {TILE_RANGES} ranges of {t_local} ({pad} padding "
            f"tiles), cap_tile {rc.cap_tile}; {card}")
        accs, fins, row_sum = [], [], torch.zeros_like(rows)
        out = {k: {"ranges": TILE_RANGES, "tiles_per_range": t_local,
                   "padding_tiles": pad, "range_ms": [],
                   "range_max_abs_err": [], "range_instances": [],
                   "range_max_tile_count": []}
               for k in ("composite_fwd", "composite_bwd")}
        for r in range(TILE_RANGES):
            base = r * t_local
            sl = slice(base, base + t_local)
            rf = (table, b.ids, ts[sl], tc[sl], rc, grid)
            a, f = composite.composite_fwd(*rf, tile_base=base)
            pa, pt = composite._composite_fwd_plain(*rf, tile_base=base)
            rb = (table, b.ids, ts[sl], tc[sl], a[:, :4].contiguous(), f,
                  ga[sl], gt[sl], rc, grid, (H, W))
            k = composite.composite_bwd(*rb, tile_base=base)
            pk = composite._composite_bwd_plain(*rb, tile_base=base)
            torch.cuda.synchronize()
            if not (torch.allclose(a, pa, rtol=1e-5, atol=1e-3) and
                    torch.allclose(f, pt, rtol=1e-5, atol=1e-5)):
                fail(f"composite_fwd at tile_base {base} disagrees with its "
                     "plain version")
            scale = float(pk.abs().amax(dim=0).max()) + 1e-3
            if not torch.allclose(k, pk, rtol=2e-4, atol=2e-5 * scale):
                fail(f"composite_bwd at tile_base {base} disagrees with its "
                     "plain version")
            errs = (max(float((a - pa).abs().max()),
                        float((f - pt).abs().max())),
                    float((k - pk).abs().max()))
            ms = (kernel_ms(lambda: composite.composite_fwd(
                      *rf, tile_base=base), "composite_fwd", 10),
                  kernel_ms(lambda: composite.composite_bwd(
                      *rb, tile_base=base), "composite_bwd", 5))
            n_inst, densest = int(tc[sl].sum()), int(tc[sl].max())
            for name, e, m in zip(("composite_fwd", "composite_bwd"), errs,
                                  ms):
                out[name]["range_ms"].append(m)
                out[name]["range_max_abs_err"].append(e)
                out[name]["range_instances"].append(n_inst)
                out[name]["range_max_tile_count"].append(densest)
            log(f"  range {r} (tile_base {base}, {n_inst} instances, densest "
                f"tile {densest}): composite_fwd {ms[0]:.3f} ms, "
                f"composite_bwd {ms[1]:.3f} ms ({card}); max|kernel - "
                f"plain| {errs[0]:.3e} / {errs[1]:.3e}")
            accs.append(a)
            fins.append(f)
            row_sum += k
        if not (torch.equal(torch.cat(accs)[:T], acc) and
                torch.equal(torch.cat(fins)[:T], fin)):
            fail("composite_fwd over tile ranges differs from the whole "
                 "launch")
        if not torch.equal(row_sum, rows):
            fail("composite_bwd rows summed over tile ranges differ from the "
                 "whole launch")
        whole = (kernel_ms(lambda: composite.composite_fwd(*fargs),
                           "composite_fwd", 10),
                 kernel_ms(lambda: composite.composite_bwd(*bargs),
                           "composite_bwd", 5))
    for name, m in zip(("composite_fwd", "composite_bwd"), whole):
        out[name]["whole_ms"] = m
        out[name]["bit_equal_to_whole"] = True
    log(f"  whole launch (tile_base 0): composite_fwd {whole[0]:.3f} ms, "
        f"composite_bwd {whole[1]:.3f} ms; ranges bit-equal to it (forward "
        f"rows; backward rows summed); {card}")
    return out


def step_profile(torch, step, state, args, iteration: int, n: int = 3):
    """Device milliseconds per step by kernel over `n` steps (after one
    warm-up step) under torch.profiler: (busy ms, {kernel: ms})."""
    from torch.profiler import ProfilerActivity, profile
    state, _ = step(state, *args, iteration)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            state, _ = step(state, *args, iteration + 1 + i)
        torch.cuda.synchronize()
    ms = {e.key: e.self_device_time_total / 1e3 / n
          for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and e.self_device_time_total > 0}
    return sum(ms.values()), ms


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_phase(torch, dev, ck, res, work_dir, data, card):
    """Phase 15 (b) and (c): the data-parallel steps of both phases and
    the tile-sharded step over a torch.distributed group of world size 1
    over NCCL (the machine has one card), from phase 7's checkpoint at
    iterations past its densification window, held against the
    single-device steps. Returns the kernel launches of the DP and TS
    steps."""
    import torch.distributed as dist
    from gi_gs_tpu_torch.parallel import collectives
    from gi_gs_tpu_torch.parallel import data_parallel as dpm
    from gi_gs_tpu_torch.parallel.tile_sharded import make_ts_phase1_step
    from gi_gs_tpu_torch.scene.dataset import load_scene
    from gi_gs_tpu_torch.train import trainer
    from gi_gs_tpu_torch.train.optim import (build_light_optimizer,
                                             build_optimizer)
    from gi_gs_tpu_torch.utils.checkpoint import load_train_state
    start = os.path.join(work_dir, "train_model", f"chkpnt{TRAIN_STEPS}.pt")
    cfg = copy.deepcopy(res["cfg"])
    cfg2 = copy.deepcopy(cfg)
    cfg2.train.indirect = True
    cfg2.train.light_base_res = LIGHT_RES
    scene = load_scene(data, eval_split=True)
    ext = scene.cameras_extent
    recs = scene.train_cameras[:2]
    cams = [r.camera(dev) for r in recs]
    imgs = [torch.as_tensor(r.image, device=dev) for r in recs]
    alphas = [torch.as_tensor(r.alpha, device=dev) for r in recs]
    bg = torch.zeros(3, device=dev)
    batch = (dpm.stack_cameras(cams), torch.stack(imgs), torch.stack(alphas),
             bg)
    first = TRAIN_STEPS + 1          # past --densify_until_iter 25
    total = {k: 0 for k in ck.launches}

    def run(step, args, label, counted=True):
        state = load_train_state(start, dev)[0]
        rows = []
        for i in range(PAR_STEPS):
            before = dict(ck.launches)
            collectives.reset_calls()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, aux = step(state, *args, first + i)
            loss = float(aux.loss)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            got = {k: ck.launches[k] - before[k] for k in before}
            for k, v in got.items():
                total[k] += v if counted else 0
            rows.append(dict(loss=loss, ms=ms, collectives=dict(
                collectives.calls), launches={k: v for k, v in got.items()
                                              if v}))
        if not all(math.isfinite(r["loss"]) for r in rows):
            fail(f"{label}: non-finite loss {[r['loss'] for r in rows]}")
        log(f"  {label}: per step ms " + ", ".join(
            f"{r['ms']:.1f}" for r in rows) + f" ({card}); losses "
            f"{[round(r['loss'], 6) for r in rows]}; collectives per step "
            f"{rows[-1]['collectives']}; launches per step "
            f"{rows[-1]['launches']}")
        return rows, state

    def single_loss(step, view):
        state = load_train_state(start, dev)[0]
        _, aux = step(state, cams[view], imgs[view], alphas[view], bg, first)
        return float(aux.loss)

    def same_mean(label, got, step):
        want = np.mean([single_loss(step, v) for v in range(2)])
        log(f"  {label}: first loss {got:.7f}, mean of the two views' "
            f"single-device losses {want:.7f}")
        if abs(got - want) > 1e-5 * abs(want):
            fail(f"{label}: loss {got} is not the mean of the views' "
                 f"single-device losses {want}")

    try:
        dist.init_process_group(
            "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=120))
        probe = torch.ones(1, device=dev)
        dist.all_reduce(probe)
        torch.cuda.synchronize()
    except (RuntimeError, ValueError) as e:
        fail(f"NCCL did not come up at world size 1: {e}")
    try:
        log(f"[parallel] torch.distributed {dist.get_backend()} world size "
            f"{dist.get_world_size()} (one card: no multi-GPU run), "
            f"{PAR_STEPS} steps each from chkpnt{TRAIN_STEPS}.pt at "
            f"iterations {first}-{first + PAR_STEPS - 1}, {SIZE}x{SIZE}")
        tx = build_optimizer(cfg.opt, ext)
        rows, _ = run(dpm.make_dp_phase1_step(cfg, ext, tx), batch,
                      "dp phase 1 (batch of 2 views)")
        same_mean("dp phase 1", rows[0]["loss"],
                  trainer.make_phase1_step(cfg, ext, tx))
        ltx = build_light_optimizer(cfg2.opt)
        step2 = dpm.make_dp_phase2_step(cfg2, ext, tx, ltx)
        rows2, _ = run(step2, batch, "dp phase 2 (batch of 2 views, "
                       "--indirect, light 256)")
        del step2
        same_mean("dp phase 2", rows2[0]["loss"],
                  trainer.make_phase2_step(cfg2, ext, tx, ltx))
        for r in rows + rows2:
            if r["collectives"] != {"all_reduce": 3, "all_gather": 0}:
                fail(f"a dp step issued {r['collectives']} collectives")
        one = (cams[0], imgs[0], alphas[0], bg)
        ts_rows, ts_state = run(make_ts_phase1_step(cfg, ext, tx), one,
                                "ts phase 1 (one view)")
        ref_rows, ref_state = run(trainer.make_phase1_step(cfg, ext, tx), one,
                                  "single-device phase 1 (the same view)",
                                  counted=False)
        for r in ts_rows:
            if r["collectives"] != {"all_reduce": 1, "all_gather": 1}:
                fail(f"a ts step issued {r['collectives']} collectives")
        lt = [r["loss"] for r in ts_rows]
        lr = [r["loss"] for r in ref_rows]
        a, b = ts_state.stats.accum, ref_state.stats.accum
        acc_err = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                   1e-30)
        log(f"  ts vs single-device: losses {lt} vs {lr}; stats.accum "
            f"within {acc_err:.2e} of its largest")
        if not np.allclose(lt, lr, rtol=1e-5, atol=0) or not torch.allclose(
                a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max())):
            fail("the tile-sharded step differs from the single-device step")
        # what the tile-sharded path adds on the device (its gather, the
        # flattened gradient all_reduce and their copies)
        busy = {}
        for label, make in (("ts", make_ts_phase1_step),
                            ("single", trainer.make_phase1_step)):
            busy[label] = step_profile(torch, make(cfg, ext, tx),
                                       load_train_state(start, dev)[0], one,
                                       first)
        extra = sorted(((k, v - busy["single"][1].get(k, 0.0))
                        for k, v in busy["ts"][1].items()),
                       key=lambda kv: -kv[1])[:5]
        log(f"  device busy per step (profile, 3 steps): ts "
            f"{busy['ts'][0]:.2f} ms, single-device {busy['single'][0]:.2f} "
            f"ms ({card}); the kernels ts adds most to: " + ", ".join(
                f"{k[:60]} +{v:.3f} ms" for k, v in extra))
    finally:
        dist.destroy_process_group()
    return total


def parity_phase(torch, dev, config_mod, render_cli, params_from_numpy, rng):
    """render_pbr_view with CUDA tensors (the kernels) against the same
    inputs on the CPU (the plain versions). Tolerance as in
    tests/test_torch_render.py: 1e-4 everywhere except the GI-fed keys,
    where a z-buffer value one ulp apart may flip one ray's exact hit test
    (one direction weight, <= 0.0031) on under 1% of pixels."""
    from gi_gs_tpu_torch.scene.cameras import make_camera
    n, cap = 3000, 4096
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    fields = gaussian_fields(rng, n, cap)
    fields["xyz"][:n] = (d * 0.8).astype(np.float32)
    fields["scaling"][:n] = rng.uniform(-4.0, -2.8, (n, 3))
    cub = random_cubemap(rng, 64)
    from gi_gs_tpu_torch.renderer import render
    cfg = config_mod.Config()
    cfg.gi = cfg.gi._replace(backend="pallas_exact")   # serving's march
    worst = {}
    outs, peaks = [], []
    for device in (dev, torch.device("cpu")):
        state = types.SimpleNamespace(
            params=params_from_numpy(fields, 3, 3, device=device),
            cubemap=torch.as_tensor(cub, device=device))
        cam = make_camera(np.eye(3), np.array([0.0, 0.0, 3.0]), 0.9, 0.7, 64,
                          48, device=device)
        bg = torch.zeros(3, device=device)
        with torch.inference_mode():
            outs.append(render_cli.render_pbr_view(cfg, state, cam, bg))
            # the argmax render (composite_fwd_peak on the card)
            peaks.append(render(cam, state.params, bg, cfg.raster, cfg.gi,
                                inference=True, argmax_depth=True))
    for key, a in outs[0].items():
        a = a.cpu().double().numpy()
        b = outs[1][key].double().numpy()
        diff = np.abs(a - b)
        worst[key] = float(diff.max()) if diff.size else 0.0
        if key in ("occlusion_map", "diffuse_rgb", "render_rgb", "indirect"):
            ok = (diff > 1e-4).mean() < 0.01 and diff.max() < 0.02
        else:
            ok = diff.max() <= 1e-4
        if not ok:
            fail(f"parity: {key} differs by {diff.max()}")
    # argmax render: a near-tie may pick another peak instance on a pixel,
    # which moves its depth and the depth-fed maps around it; allow that
    # on under 1% of pixels, 1e-4 everywhere else
    depth_fed = ("depth_map", "normal_map_from_depth", "normal_from_depth_mask",
                 "depth_pos", "occlusion_map")
    peak_worst = {}
    for key, a in peaks[0].items():
        diff = np.abs(a.cpu().double().numpy()
                      - peaks[1][key].double().numpy())
        peak_worst[key] = float(diff.max()) if diff.size else 0.0
        ok = ((diff > 1e-4).mean() < 0.01 if key in depth_fed
              else diff.max() <= 1e-4)
        if not ok:
            fail(f"parity (argmax render): {key} differs by {diff.max()} on "
                 f"{(diff > 1e-4).mean():.2%} of pixels")
    k = max(worst, key=worst.get)
    kp = max(peak_worst, key=peak_worst.get)
    return (f"{k} {worst[k]:.2e}; argmax render: worst key {kp} "
            f"{peak_worst[kp]:.2e}")


# the kernels of both training phases, which the reduced gates must launch
GATE_KERNELS = ("expand", "composite_fwd", "composite_bwd",
                "reduce_instance_grads", "gi_march_coherent", "patch_fwd",
                "patch_bwd", "sh_fwd", "sh_bwd", "adam")


def quality_phase(torch, dev, ck, card):
    """Phase 17: tests/test_quality.py's reduced gates on the card, under
    its bars, with the launches of the two runs. Returns the launches."""
    from gi_gs_tpu_torch import quality_gate as qg
    torch.cuda.empty_cache()
    ck.reset_launches()
    r1 = qg.run_phase1_gate(size=64, iters=1200, n_train=16, n_test=2,
                            capacity=4096, max_capacity=16384, n_gauss=500,
                            n_init=2000, device=dev)
    r2 = qg.run_phase2_gate(size=64, iters=200, n_train=8, n_test=2,
                            capacity=2048, n_gauss=500, light_res=64,
                            device=dev)
    launches = dict(ck.launches)
    log(f"[quality] phase 1 (64 px, 1200 steps): test PSNR "
        f"{r1['test_psnr']:.4f} dB (bar 19), alive {r1['alive']} of "
        f"{r1['capacity']}, {r1['steps_per_s']:.2f} steps/s, "
        f"{r1['seconds']:.1f} s; phase 2 (64 px, 200 steps, light 64): "
        f"albedo PSNR {r2['albedo_psnr']:.4f} dB (bar 18), irradiance "
        f"correlation {r2['env_irradiance_corr']:.4f} (bar 0.75), env "
        f"correlation {r2['env_corr']:.4f}, {r2['steps_per_s']:.2f} "
        f"steps/s, {r2['seconds']:.1f} s ({card}); launches {launches}")
    log("  phase-1 trajectory " + json.dumps(r1["trajectory"]))
    if not r1["test_psnr"] > 19.0:
        fail(f"the reduced phase-1 gate missed its bar: {r1}")
    if not (r2["albedo_psnr"] > 18.0 and r2["env_irradiance_corr"] > 0.75):
        fail(f"the reduced phase-2 gate missed its bars: {r2}")
    missing = [k for k in GATE_KERNELS if not launches[k]]
    if missing:
        fail(f"the quality gate launched no {missing}")
    return launches


def dryrun_phase(torch, dev, ck):
    """Phase 18: dryrun_multichip(1) over a world-size-1 NCCL group (the
    machine has one card). Returns the kernel launches of the run."""
    import torch.distributed as dist
    from gi_gs_tpu_torch import dryrun
    try:
        dist.init_process_group(
            "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=120))
    except (RuntimeError, ValueError) as e:
        fail(f"NCCL did not come up at world size 1: {e}")
    ck.reset_launches()
    t0 = time.time()
    try:
        res = dryrun.dryrun_multichip(1, device=dev)
    except AssertionError as e:
        fail(f"the dry run failed: {e}")
    finally:
        dist.destroy_process_group()
    launches = dict(ck.launches)
    log(f"[dryrun] dryrun_multichip(1) over NCCL in {time.time() - t0:.1f} "
        f"s: densify {res['phase1_dp']['alive']}, cubemap change "
        f"{res['phase2_dp']['cubemap_change']:.4f}, multihost capacity "
        f"{res['multihost']['capacity']}; launches {launches}")
    return launches


def relight_phase(torch, dev, cfg, rng):
    """Phase 19: the light's prefilter tables kept on the card. The store
    is emptied, so the first build_light uploads the tables; later builds
    of new 256 cubemaps read them. A relit light (through the store) is
    held bit for bit against one built from a fresh upload
    (`cm.build_prefilter_tables`); each later build runs under the
    profiler, which must show no host-to-device copy of 1 MB or more, and
    in span mode, where it is the root span light with the stages
    prefilter_tables and build_mips under it and counts one light_builds.
    Returns the phase's numbers."""
    from torch.profiler import ProfilerActivity, profile
    from gi_gs_tpu_torch.cli import render_cli
    from gi_gs_tpu_torch.models import light as light_mod
    from gi_gs_tpu_torch.ops import cubemap as cm
    from gi_gs_tpu_torch.utils import timing

    def cube():
        return torch.as_tensor(random_cubemap(rng, LIGHT_RES), device=dev)

    def h2d(fn):
        """fn()'s result and its host-to-device copies' bytes."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_"),
                            "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)
        return out, [int(e.get("args", {}).get("bytes", 0)) for e in events
                     if "HtoD" in e.get("name", "")]

    light_mod._tables.clear()
    torch.cuda.empty_cache()
    first_cube = cube()
    t0 = time.time()
    _, first_copies = h2d(lambda: render_cli.build_light(cfg, first_cube))
    first_s = time.time() - t0
    if sum(first_copies) < 1 << 30:
        fail(f"the first light copied {sum(first_copies)} B to the card; "
             "the tables' upload was not seen")
    later, big, small = [], [], 0
    for _ in range(3):
        c = cube()
        timing.start_spans()
        _, copies = h2d(lambda: render_cli.build_light(cfg, c))
        rec = timing.stop_spans()
        big += [b for b in copies if b >= 1 << 20]
        small += sum(copies)
        roots = [s for s in rec.spans if s.parent == 0]
        kids = [s.name for s in rec.spans if s.parent == roots[0].id] \
            if len(roots) == 1 else []
        if [r.name for r in roots] != ["light"] or \
                kids != ["prefilter_tables", "build_mips"] or \
                rec.counters.get("light_builds") != 1:
            fail(f"a later light's spans "
                 f"{[(s.name, s.parent) for s in rec.spans]} and counters "
                 f"{rec.counters}")
        later.append(cuda_ms(lambda: render_cli.build_light(cfg, c), 10))
    if big:
        fail(f"a later light copied {big} B to the card in one copy")
    c = cube()
    with torch.inference_mode():
        got = render_cli.build_light(cfg, c)
        spec, arrays = cm.build_prefilter_tables(
            LIGHT_RES, min_res=light_mod.LIGHT_MIN_RES,
            min_roughness=light_mod.MIN_ROUGHNESS,
            max_roughness=light_mod.MAX_ROUGHNESS, device=dev)
        want = light_mod.build_mips_packed(c, spec, arrays)
    equal = [torch.equal(a, b) for a, b in
             zip(got.specular + (got.diffuse,),
                 want.specular + (want.diffuse,))]
    if not all(equal):
        fail(f"a relit light through the store differs from a fresh "
             f"upload's, level by level {equal}")
    out = {"first_build_s": first_s,
           "first_build_h2d_bytes": sum(first_copies),
           "later_build_ms": later,
           "later_builds_h2d_bytes": small,
           "tables_bytes": sum(a.numel() * a.element_size()
                               for a in arrays),
           "levels_bit_equal": len(equal)}
    log(f"[relight] first build_light {first_s:.2f} s (its tables' upload "
        f"{out['first_build_h2d_bytes'] / 2**30:.3f} GiB); later builds "
        f"{', '.join(f'{x:.3f}' for x in later)} ms (CUDA events, 10 each), "
        f"{small} B copied to the card by the three, none of 1 MB or more; "
        f"{len(equal)} levels of a "
        f"relit light bit-equal to a fresh upload's")
    return out


if __name__ == "__main__":
    main()
