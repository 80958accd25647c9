#!/usr/bin/env python3
"""Run the scene of chip_smoke.py's phase 6 (render parity) in fresh
processes on one NVIDIA GPU, to tell a per-process fault from a per-call one
and to name the stage and the device that moved.

    python3 tools/parity_processes.py [--processes 12] [--parallel 4]
                                      [--repeats 2] [--quick]
                                      [--checkout DIR]

Each process is a new interpreter (a new CUDA context and address space).
It builds the scene of `chip_smoke.parity_phase` (seed 1: 3000 Gaussians,
a 64x48 view, the exact march) and renders it with `render_pbr_view`:
  cpu       on the CPU at the default thread count (the reference),
  cuda      `--repeats` times on the card,
  cuda*     on the card after the caching allocator was filled with freed
            NaN blocks (an output that reads memory it never wrote moves),
  cpu1      on the CPU with one thread,
  cpu*      on the CPU after NaN blocks were freed to the host allocator.
`--quick` renders only cpu, cuda and, last, cpu#2 (a second CPU render,
which shows whether the first one moved): three renders instead of six.
Every render records, each as a short md5, the rasterizer's stages (the
SH colours `sh`; the inputs of `build_covariance_3d`: the rounded scales
`scl` (`get_scaling`'s output) and the raw quaternions `rot`;
preprocess's inputs: the means `xyz`, the 3D covariances `cov`, the
activated opacities `op`, the camera matrices `cam`; its
output `pre`, and where that moved, which of its fields; the binned
instance ids `bin`, the compositing table `tab`, the composited
accumulators `acc`),
the march inputs and outputs (the SSAO call's normal_view `nv`, depth_pos
`pos` and occlusion sum `occ`; the SSR call's normal_view `snv`, rgb `rgb`
and indirect sum `dif`) and the render's outputs (`out`). The process
prints one HOST line (CPU model, ATen CPU capability, thread counts) and
one RESULT line: the
verdict of the card's first render against the CPU's under phase 6's
tolerance (the GI-fed keys may differ by more than 1e-4 on under 1% of
pixels and by at most 0.02, every other key by at most 1e-4), the stage
hashes of both devices, and for every other render the stages whose hash
moved from its device's first render ("same" if none). FAIL names the keys
out of tolerance with their share of pixels and largest difference. Last,
the count of each distinct HOST and RESULT line. `--checkout DIR` runs
another checkout's package and chip_smoke.py (for example the parent
commit, unpacked with `git archive`). Needs a card.
"""
from __future__ import annotations

import argparse
import collections
import hashlib
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GI_KEYS = ("occlusion_map", "diffuse_rgb", "render_rgb", "indirect")
STAGES = ("sh", "scl", "rot", "xyz", "cov", "op", "cam", "pre", "bin", "tab",
          "acc", "nv", "pos", "occ", "snv", "rgb", "dif", "out")
# the fields of preprocess's output hashed one by one (`pre` is all of them)
PRE_FIELDS = ("means2d", "conic", "depth", "pos_view", "radius", "rect_min",
              "tiles_touched")


def md5(tensors) -> str:
    return hashlib.md5(b"".join(t.detach().cpu().contiguous().numpy()
                                .tobytes() for t in tensors)).hexdigest()[:6]


def host_line(torch) -> str:
    model = "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            model = next((ln.split(":", 1)[1].strip() for ln in f
                          if ln.startswith("model name")), model)
    except OSError:
        pass
    return (f"HOST {model} | capability "
            f"{torch.backends.cpu.get_cpu_capability()} | threads "
            f"{torch.get_num_threads()} | cores {os.cpu_count()}")


def poison(torch, device: str) -> None:
    """Allocate blocks of many sizes filled with NaN and free them: the
    allocator (PyTorch's caching allocator on the card, malloc on the host)
    hands them out again to the next `torch.empty` calls."""
    junk = [torch.full((n,), float("nan"), device=device)
            for n in (2 ** k + 37 * r for k in range(8, 21)
                      for r in range(4))]
    del junk


def worker(repeats: int, quick: bool) -> None:
    import types

    import numpy as np
    import torch
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from gi_gs_tpu_torch import config as config_mod
    from gi_gs_tpu_torch.cli import render_cli
    from gi_gs_tpu_torch.models.gaussians import params_from_numpy
    from gi_gs_tpu_torch.ops import screen_space as ss
    from gi_gs_tpu_torch.ops import sh as sh_ops
    from gi_gs_tpu_torch.ops.rasterize import pipeline
    from gi_gs_tpu_torch.scene.cameras import make_camera
    from gi_gs_tpu_torch.utils import math_utils

    print(host_line(torch), flush=True)
    rng = np.random.RandomState(1)       # chip_smoke: --seed 0, plus 1
    n, cap = 3000, 4096
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    fields = cs.gaussian_fields(rng, n, cap)
    fields["xyz"][:n] = (d * 0.8).astype(np.float32)
    fields["scaling"][:n] = rng.uniform(-4.0, -2.8, (n, 3))
    cub = cs.random_cubemap(rng, 64)
    cfg = config_mod.Config()
    cfg.gi = cfg.gi._replace(backend="pallas_exact")

    calls, staged = [], {}
    march = ss.march

    def recording(normal_view, pos, rgb, fx, fy, p):
        occ, dif = march(normal_view, pos, rgb, fx, fy, p)
        calls.append((normal_view.clone(), pos.clone(),
                      None if rgb is None else rgb.clone(), occ.clone(),
                      dif.clone()))
        return occ, dif

    ss.march = recording

    def stage(name, module, attr):
        """Record the tensors `module.attr` returns under `name`."""
        fn = getattr(module, attr)

        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            items = out if isinstance(out, tuple) else (out,)
            staged[name] = md5(t for t in items if isinstance(t, torch.Tensor))
            return out
        setattr(module, attr, wrapped)

    stage("sh", sh_ops, "sh_to_rgb")
    build_cov = math_utils.build_covariance_3d

    def recorded_cov(scaling, rotation_raw, *a, **kw):
        staged.update(scl=md5([scaling]), rot=md5([rotation_raw]))
        return build_cov(scaling, rotation_raw, *a, **kw)
    math_utils.build_covariance_3d = recorded_cov
    preprocess = pipeline.preprocess

    def recorded_preprocess(means3d, cov3d, w2c, full_proj, *a, **kw):
        staged.update(xyz=md5([means3d]), cov=md5([cov3d]),
                      op=md5([kw["opacity"]]), cam=md5([w2c, full_proj]))
        out = preprocess(means3d, cov3d, w2c, full_proj, *a, **kw)
        staged["pre"] = md5(t for t in out if isinstance(t, torch.Tensor))
        staged["fields"] = {f: md5([getattr(out, f)]) for f in PRE_FIELDS}
        return out
    pipeline.preprocess = recorded_preprocess
    stage("bin", pipeline, "bin_and_sort")
    stage("tab", pipeline, "composite_table")
    stage("acc", pipeline, "composite")

    def render(device):
        state = types.SimpleNamespace(
            params=params_from_numpy(fields, 3, 3, device=device),
            cubemap=torch.as_tensor(cub, device=device))
        cam = make_camera(np.eye(3), np.array([0.0, 0.0, 3.0]), 0.9, 0.7,
                          64, 48, device=device)
        calls.clear()
        staged.clear()
        with torch.inference_mode():
            out = render_cli.render_pbr_view(cfg, state, cam,
                                             torch.zeros(3, device=device))
        out = {k: v.detach().cpu().clone() for k, v in out.items()}
        (nv, pos, _, occ, _), (snv, _, rgb, _, dif) = calls
        stages = dict(staged, nv=md5([nv]), pos=md5([pos]), occ=md5([occ]),
                      snv=md5([snv]), rgb=md5([rgb]), dif=md5([dif]),
                      out=md5(out[k] for k in sorted(out)))
        return out, stages

    def moved(ref, got):
        diff = [s for s in STAGES if got[s] != ref[s]]
        if "pre" in diff:
            diff[diff.index("pre")] = "pre(" + ",".join(
                f for f in PRE_FIELDS
                if got["fields"][f] != ref["fields"][f]) + ")"
        return ",".join(diff) if diff else "same"

    cpu, cpu_st = render("cpu")
    cuda, cuda_st = render("cuda")
    if quick:
        others = [("cpu#2", render("cpu")[1], cpu_st)]
    else:
        others = [(f"cuda#{i + 2}", render("cuda")[1], cuda_st)
                  for i in range(repeats - 1)]
        poison(torch, "cuda")
        others.append(("cuda*", render("cuda")[1], cuda_st))
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        others.append(("cpu1", render("cpu")[1], cpu_st))
        torch.set_num_threads(threads)
        poison(torch, "cpu")
        others.append(("cpu*", render("cpu")[1], cpu_st))

    bad = []
    for key, a in cuda.items():
        diff = (a.double() - cpu[key].double()).abs()
        share = float((diff > 1e-4).double().mean()) if diff.numel() else 0.0
        worst = float(diff.max()) if diff.numel() else 0.0
        ok = (share < 0.01 and worst < 0.02) if key in GI_KEYS \
            else worst <= 1e-4
        if not ok:
            bad.append(f"{key} {share:.4f} {worst:.7f}")
    fmt = lambda st: " ".join(f"{s}:{st[s]}" for s in STAGES)
    print(f"RESULT {'ok' if not bad else 'FAIL'} | cpu {fmt(cpu_st)} | cuda "
          f"{fmt(cuda_st)} | "
          + ", ".join(f"{name} {moved(ref, st)}" for name, st, ref in others)
          + (" | " + "; ".join(bad) if bad else ""), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--processes", type=int, default=12)
    ap.add_argument("--parallel", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--checkout", default=REPO)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.repeats, args.quick)
        return
    root = os.path.abspath(args.checkout)
    cmd = [sys.executable, os.path.abspath(__file__), "--worker",
           "--repeats", str(args.repeats)] + (["--quick"] if args.quick
                                              else [])
    lines = []
    for first in range(0, args.processes, args.parallel):
        procs = [subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for _ in range(min(args.parallel, args.processes - first))]
        for p in procs:
            out, _ = p.communicate(timeout=600)
            got = [ln for ln in out.splitlines()
                   if ln.startswith(("HOST", "RESULT"))]
            if not any(ln.startswith("RESULT") for ln in got):
                tail = " / ".join(out.strip().splitlines()[-2:])
                got.append(f"RESULT ERROR {tail}")
            lines.extend(got)
            print("\n".join(got), flush=True)
    n = sum(ln.startswith("RESULT") for ln in lines)
    print(f"{root}: {n} processes")
    for line, count in collections.Counter(lines).most_common():
        print(f"  {count} x {line}")


if __name__ == "__main__":
    main()
