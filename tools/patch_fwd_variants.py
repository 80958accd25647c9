#!/usr/bin/env python3
"""Time design variants of the port's patch_fwd kernel on one NVIDIA GPU,
per level of the 256 light's prefilter, and check their outputs bit for
bit.

    python3 tools/patch_fwd_variants.py [--seed 0] [--reps 10] [--rounds 3]
                                        [--baseline DIR] [--only NAME,...]

Each variant is the source of gi_gs_tpu_torch/csrc/patch_fwd.cu with one
design choice changed by a text substitution (VARIANTS below; `kept` is
the source as it is; `tile_32x8` replaces the whole file with the tile
kernel that the ring design replaced), or the kept source launched with
another ring depth (SHAPES), each built into a library of its own with the
port's nvcc flags. `--baseline DIR` also builds a checkout's patch_fwd.cu
as it is (for example the parent commit, unpacked with `git archive`; a
source whose launcher has no `stages` argument is called without it).
Every design runs the three
patch levels of the 256 light (R = 256, 128, 64;
`build_prefilter_tables(256)`) on random padded faces: first once per
level, its output compared bit for bit with the plain `_patch_fwd_plain`
(a design that faults stops the tool there, named), then timed with CUDA
events per level, every design once per round for `--rounds` rounds in
turn (min and median per level and of the sum). Prints one line per
design and level with its bound share and launch shape, the card's name,
power limit and SM clocks, and last a JSON object of every number. Needs a
card; builds nothing into the package's own cache.

A one-off experiment kept to back the design-variant times in PERF.md:
the substitutions match the kernel's source text line for line, so an edit
of those lines makes the tool raise (it names the variant and the missing
text) until its VARIANTS are rewritten.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = ("gi_gs_tpu_torch", "csrc")
SOURCES = ("common.cuh", "patch_fwd.cu")
KERNEL_ARGS = ("const __grid_constant__ CUtensorMap wmap, "
               "const float* __restrict__ pad,")
LAUNCH_ARGS = "      wmap, static_cast<const float*>(pad),"
COPIES = """      if (lane == 0) {
        tma_load_3d(st, &wmap, 0, y, (f * P + dy) * P, &full[s]);
      } else if (lane <= 3) {
        const int c = lane - 1;
        gigs_bulk_load(st + P * R + c * slot, pad + start - a + c * E * E,
                       pbytes, &full[s]);
      }
"""
# W as P bulk copies of one row each (R * 4 bytes) per stage, issued by the
# producer's lanes in parallel, as patch_bwd.cu copies its W rows; the
# padded rows as before.
BULK_COPIES = """      const float* wsrc = W + (static_cast<size_t>(f * P + dy) * P) * R * R
                          + y * R;
      for (int q = lane; q < P + 3; q += 32) {
        if (q < P) {
          gigs_bulk_load(st + q * R, wsrc + static_cast<size_t>(q) * R * R,
                         4u * R, &full[s]);
        } else {
          const int c = q - P;
          gigs_bulk_load(st + P * R + c * slot, pad + start - a + c * E * E,
                         pbytes, &full[s]);
        }
      }
"""
EXPECT = ("      if (lane == 0)\n"
          "        gigs_mbar_arrive_expect_tx(&full[s], wbytes + 3 * pbytes);")
FMAS = """      a0 += pp[dx] * wv;
      a1 += pp[slot + dx] * wv;
      a2 += pp[2 * slot + dx] * wv;
"""
UNROLL = "#pragma unroll 8\n    for (int dx = 0; dx < P; ++dx) {"

# The tile kernel the ring design replaced (32 x 8 texels per CTA, the
# padded window staged once, W read from global memory by every thread for
# every offset), with the launcher taking (and ignoring) stages.
TILE_32X8 = r'''#include "common.cuh"

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;

__global__ void __launch_bounds__(kBX * kBY) patch_fwd_kernel(
    const float* __restrict__ W, const float* __restrict__ pad,
    float* __restrict__ out, int R, int P, int h) {
  extern __shared__ float win[];  // [3][kBY + 2h][kBX + 2h]
  const int f = blockIdx.z;
  const int x0 = blockIdx.x * kBX;
  const int y0 = blockIdx.y * kBY;
  const int E = R + 2 * h;
  const int WX = kBX + 2 * h;
  const int WY = kBY + 2 * h;
  const int plane = WX * WY;
  const float* padf = pad + static_cast<size_t>(f) * 3 * E * E;
  const int tid = threadIdx.y * kBX + threadIdx.x;
  for (int e = tid; e < 3 * plane; e += kBX * kBY) {
    const int c = e / plane;
    const int r = (e - c * plane) / WX;
    const int q = e - c * plane - r * WX;
    const int gy = y0 + r;
    const int gx = x0 + q;
    win[e] = (gy < E && gx < E)
                 ? padf[(static_cast<size_t>(c) * E + gy) * E + gx]
                 : 0.0f;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= R || y >= R) return;
  const size_t rr = static_cast<size_t>(R) * R;
  const float* wp = W + static_cast<size_t>(f) * P * P * rr +
                    static_cast<size_t>(y) * R + x;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  for (int dy = 0; dy < P; ++dy) {
    const float* row = win + (threadIdx.y + dy) * WX + threadIdx.x;
    for (int dx = 0; dx < P; ++dx) {
      const float wv = wp[static_cast<size_t>(dy * P + dx) * rr];
      a0 += row[dx] * wv;
      a1 += row[plane + dx] * wv;
      a2 += row[2 * plane + dx] * wv;
    }
  }
  float* o = out + static_cast<size_t>(f) * 3 * rr + static_cast<size_t>(y) * R + x;
  o[0] = a0;
  o[rr] = a1;
  o[2 * rr] = a2;
}

cudaError_t opt_in_smem(int device) {
  static unsigned long long done = 0;
  return gigs_opt_in_smem(device, done, patch_fwd_kernel);
}

}  // namespace

GIGS_API int gigs_patch_fwd(int device, const void* W, const void* pad,
                            void* out, int R, int P, int h, int stages,
                            void* stream) {
  (void)stages;
  cudaError_t err = gigs_use_device(device);
  if (err == cudaSuccess) err = opt_in_smem(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      static_cast<size_t>(3) * (kBY + 2 * h) * (kBX + 2 * h) * sizeof(float);
  const dim3 block(kBX, kBY);
  const dim3 grid((R + kBX - 1) / kBX, (R + kBY - 1) / kBY, 6);
  patch_fwd_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<const float*>(pad),
      static_cast<float*>(out), R, P, h);
  GIGS_RETURN_LAUNCH_STATUS();
}
'''


def sub(old, new: str, f: str = "patch_fwd.cu"):
    """Replace `old` by `new` in `f`; old None replaces the whole file."""
    return (f, old, new)


# name -> [(file, old text or None, new text)]
VARIANTS = {
    "kept": [],
    "bulk_rows": [
        sub(KERNEL_ARGS, "const __grid_constant__ CUtensorMap wmap, "
            "const float* __restrict__ W, const float* __restrict__ pad,"),
        sub(LAUNCH_ARGS, "      wmap, static_cast<const float*>(W), "
            "static_cast<const float*>(pad),"),
        sub(COPIES, BULK_COPIES)],
    "unroll4": [sub(UNROLL, UNROLL.replace("unroll 8", "unroll 4"))],
    "unroll16": [sub(UNROLL, UNROLL.replace("unroll 8", "unroll 16"))],
    "tile_32x8": [sub(None, TILE_32X8)],
    # diagnostics (not bit-equal): the copies without the arithmetic, and
    # the arithmetic on whatever the ring holds, without copies
    "no_compute": [sub(FMAS, "      a0 += wv;\n")],
    "no_copies": [sub(EXPECT, "      if (lane == 0) gigs_mbar_arrive(&full[s]);"),
                  sub(COPIES, "")],
}
# The kept library launched with other ring depths: name -> the CTAs per
# SM the ring is sized for (0: 2 stages).
SHAPES = {"stages2": 0, "two_per_sm": 2, "four_per_sm": 4}


def shape_at(R: int, h: int, per_sm: int) -> dict:
    """cubemap.patch_fwd_shape's arithmetic with the ring sized for
    `per_sm` CTAs per SM (0: 2 stages)."""
    P, E = 2 * h + 1, R + 2 * h
    stage = (P * R + 3 * ((E + 6) & ~3) + 31) & ~31
    stages = 2 if per_sm == 0 else max(
        2, min(8, P, (233472 // per_sm - 1024) // (4 * stage + 16)))
    return dict(stages=stages, smem=stages * stage * 4 + 2 * stages * 8,
                grid=[1, R, 6])


def build(ck, root: str, baseline: str | None):
    """Compile every variant (and the baseline) in parallel; returns
    {name: CDLL}. A variant other than `kept` that fails to build is
    printed and left out."""
    csrc = os.path.join(REPO, *CSRC)
    jobs = []
    for name, subs in VARIANTS.items():
        d = os.path.join(root, name)
        os.makedirs(d)
        text = {f: open(os.path.join(csrc, f)).read() for f in SOURCES}
        for f, old, new in subs:
            if old is None:
                text[f] = new
                continue
            if old not in text[f]:
                raise RuntimeError(f"{name}: {old!r} is not in {f}")
            text[f] = text[f].replace(old, new)
        for f, t in text.items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(t)
        jobs.append((name, d))
    if baseline:
        jobs.append(("baseline", os.path.join(os.path.abspath(baseline),
                                              *CSRC)))
    procs = []
    for name, d in jobs:
        so = os.path.join(root, f"{name}.so")
        cmd = [ck.nvcc_path(), *ck.NVCC_FLAGS, "-shared", "-o", so,
               os.path.join(d, "patch_fwd.cu")]
        procs.append((name, d, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, d, so, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            if name == "kept":
                raise RuntimeError(f"nvcc failed for {name}:\n{out}")
            print(f"[build] {name}: FAILED\n{out}", flush=True)
            continue
        regs = [ln.split(":", 1)[1].strip() for ln in out.splitlines()
                if "registers" in ln]
        print(f"[build] {name}: {regs}", flush=True)
        lib = ctypes.CDLL(so)
        new = "int stages" in open(os.path.join(d, "patch_fwd.cu")).read()
        args = ck.signatures()["gigs_patch_fwd"]
        lib.gigs_patch_fwd.argtypes = args if new else args[:7] + args[-1:]
        libs[name] = (lib, new)
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--baseline", default="")
    ap.add_argument("--only", default="",
                    help="comma-separated designs to run (default all)")
    args = ap.parse_args()
    if args.only:
        keep = args.only.split(",")
        for table in (VARIANTS, SHAPES):
            for name in list(table):
                if name not in keep and name != "kept":
                    del table[name]
    import torch
    if not torch.cuda.is_available():
        sys.exit("patch_fwd_variants: needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from gi_gs_tpu_torch.ops import cubemap as cm
    from gi_gs_tpu_torch.ops import cuda_kernels as ck

    dev = torch.device("cuda")
    work = tempfile.mkdtemp(prefix="patch_fwd_variants_")
    try:
        libs = build(ck, work, args.baseline or None)
        # design -> (library, takes stages, shape(R, h) or None
        # where the launcher picks its own: the tile kernel, a baseline)
        designs = {name: (lib, new, cm.patch_fwd_shape
                          if new and name != "tile_32x8" else None)
                   for name, (lib, new) in libs.items()}
        for name, per_sm in SHAPES.items():
            designs[name] = (libs["kept"][0], True,
                             lambda R, h, per_sm=per_sm:
                             shape_at(R, h, per_sm))
        spec, arrays = cm.build_prefilter_tables(256, device=dev)
        ops, _ = cm.level_operators(spec, arrays)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        levels = []
        for sp, op in zip(spec, ops):
            if sp[0] == "dense":
                continue
            h, Wt = sp[1], op[1]
            R = Wt.shape[-1]
            E = R + 2 * h
            pad = torch.rand(6, 3, E, E, device=dev, generator=gen)
            levels.append(dict(R=R, P=2 * h + 1, h=h, W=Wt, pad=pad,
                               out=torch.empty(6, 3, R, R, device=dev),
                               plain=cm._patch_fwd_plain(Wt, pad, h)))
        stream = lambda: torch.cuda.current_stream().cuda_stream

        def launch(design, lv):
            lib, new, shape = design
            a = [0, lv["W"].data_ptr(), lv["pad"].data_ptr(),
                 lv["out"].data_ptr(), lv["R"], lv["P"], lv["h"]]
            if new:
                a.append(shape(lv["R"], lv["h"])["stages"] if shape else 1)
            err = lib.gigs_patch_fwd(*a, stream())
            assert err == 0, err

        # each design once on every level, checked against the plain
        # version before any is timed (a design that faults is named here)
        same = {}
        for name, design in designs.items():
            print(f"checking {name}", flush=True)
            for lv in levels:
                lv["out"].fill_(float("nan"))
                launch(design, lv)
                torch.cuda.synchronize()
                same[name, lv["R"]] = bool(torch.equal(lv["out"], lv["plain"]))
        times = {name: {lv["R"]: [] for lv in levels} for name in designs}
        for _ in range(args.rounds):
            for name, design in designs.items():
                for lv in levels:
                    times[name][lv["R"]].append(
                        cs.cuda_ms(lambda: launch(design, lv), args.reps))
        results = {}
        for name, design in designs.items():
            row = {}
            for lv in levels:
                ms = times[name][lv["R"]]
                nbytes = (lv["W"].numel() + lv["pad"].numel()
                          + lv["out"].numel()) * 4
                b_ms = cs.bound(nbytes, 0.0)[0]
                shape = design[2](lv["R"], lv["h"]) if design[2] else {}
                row[lv["R"]] = dict(
                    P=lv["P"], ms_min=min(ms), ms_median=float(np.median(ms)),
                    ms=ms, bound_ms=b_ms, bound_share=b_ms / min(ms),
                    bit_equal_to_plain=same[name, lv["R"]],
                    shape={k: shape[k] for k in ("stages", "smem", "grid")
                           if k in shape})
                print(f"{name} R={lv['R']} P={lv['P']}: min {min(ms):.4f} ms, "
                      f"median {np.median(ms):.4f} ms, bound {b_ms:.4f} ms "
                      f"({b_ms / min(ms):.1%}); bit-equal to the plain "
                      f"version: {row[lv['R']]['bit_equal_to_plain']}; "
                      f"shape {row[lv['R']]['shape']}", flush=True)
            sums = [sum(times[name][lv["R"]][i] for lv in levels)
                    for i in range(args.rounds)]
            row["sum"] = dict(ms_min=min(sums),
                              ms_median=float(np.median(sums)), ms=sums)
            print(f"{name} 3 levels: min {min(sums):.4f} ms, median "
                  f"{np.median(sums):.4f} ms", flush=True)
            results[name] = row
    finally:
        shutil.rmtree(work, ignore_errors=True)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(cs.card_line(), flush=True)
    print(f"SM clock, max SM clock: {clocks.strip()}", flush=True)
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
