#!/usr/bin/env python3
"""Time design variants of the port's patch_bwd kernel on one NVIDIA GPU,
per level of the 256 light's prefilter, and check their outputs bit for
bit.

    python3 tools/patch_variants.py [--seed 0] [--reps 10] [--rounds 3]
                                    [--baseline DIR] [--sass DIR]
                                    [--only NAME,...]

Each variant is the source of gi_gs_tpu_torch/csrc/patch_bwd.cu with one
design choice changed by a text substitution (VARIANTS below; `kept` is
the source as it is; `tma_tiles` replaces the whole file with the tile
design measured before the row design), built into a library of its own
with the port's nvcc flags. `--baseline DIR` also builds a checkout's
patch_bwd.cu as it is (for example the parent commit, unpacked with `git
archive`). Every design runs the three patch levels of the 256 light
(R = 256, 128, 64; `build_prefilter_tables(256)`) on random cotangents:
first once per level, its output compared bit for bit with the plain
`_patch_bwd_plain` (a design that faults stops the tool there, named),
then timed with CUDA events per level, every design once per round for
`--rounds` rounds in turn (min and median per level and of the sum).
`--sass DIR` writes the SASS of the kept and baseline libraries there
(cuobjdump) and prints each kernel's SASS instructions per weight: the
instructions from its first to its last FMUL (the offset loop, unrolled)
over a third of its FMULs (three per weight). Prints one line per design
and level, the card's name, power limit and SM clocks, and last a JSON
object of every number. Needs a card; builds nothing into the package's
own cache.

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
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = ("gi_gs_tpu_torch", "csrc")
SOURCES = ("common.cuh", "patch_bwd.cu")
STAGES = "constexpr int kStages = 2;"
WARPS_X = "constexpr int kMaxWarpsX = 16;                     // CTA columns <= 512"
UNROLL = "#pragma unroll 8\n    for (int k = 0; k < ndx; ++k) {"
FMAS = """      a0 += gp[-k] * wv;
      a1 += gp[S - k] * wv;
      a2 += gp[2 * S - k] * wv;
"""
EXPECT = ("      if (lane == 0) gigs_mbar_arrive_expect_tx(&full[s], (ndx + 3) * "
          "bytes);")
COPIES = "      for (int q = lane; q < ndx + 3; q += 32) {"
GAP = "  c.G = (P - 1 + 3) & ~3;"
CONSUMER_X = "  const int X = X0 + 32 * warp + lane;"
WARP_CUT = """  const int Xw = X0 + 32 * warp;
  const int X = Xw + lane;
  const int k0 = max(dx0, Xw - (s0 + L) + 1) - dx0;
  const int nk = min(dx1, Xw + 31 - s0) - dx0 + 1 - k0;"""


def sub(old, new: str, f: str = "patch_bwd.cu"):
    """Replace `old` by `new` in `f`; old None replaces the whole file."""
    return (f, old, new)


def const(text: str, value: int):
    """`constexpr int kName = <value>;` in place of the line `text`."""
    return sub(text, text.split("=")[0] + f"= {value};")


# The tile design: 32 x 8 output tiles of one face, 8 consumer warps (a
# row each) and a producer lane issuing one TMA box of 36 x 8 weights per
# offset (column X0 - dx rounded down to 16 bytes, zero fill outside the
# face), 16 boxes per stage, 4 stages, the g window of the tile as one
# more box; the offsets cut per tile.
TMA_TILES = r'''// Transpose of the GGX prefilter's locally connected halo filter:
//   pad_bar[f, c, Y, X] = sum_{dy, dx} g[f, c, Y - dy, X - dx] * W[f, dy * P + dx, Y - dy, X - dx]
// over the offsets whose source texel (Y - dy, X - dx) lies in [0, R)^2.
//
// Replaces: gi_gs_tpu/ops/pallas_patch.py:patch_apply_bwd (_bwd_kernel,
//   pallas_patch.py:61-80), the scatter form
//   pad_bar[f, c, y + dy, x + dx] += g[f, c, y, x] * W[f, p, y, x].
//   W [6, P^2, R, R] is the static weight table of cubemap._patch_tables,
//   g [6, 3, R, R] the cotangent of the filtered level, pad_bar
//   [6, 3, R + 2h, R + 2h] the cotangent of the halo-padded faces
//   (P = 2h + 1).
//
// Bound on the H100: bytes. W is read once (6 P^2 R^2 floats: 354 MB at
//   R = 256, P = 15; 661 MB at R = 128, P = 41; 319 MB at R = 64, P = 57)
//   against 6 flops per weight.
// Summation order: for each output texel, the offsets in order
//   p = dy * P + dx = 0 .. P^2 - 1 (dy outer, dx inner), each product
//   g * W added to one running f32 sum, as `_patch_bwd_plain` adds them.
// Design: the gather form. One thread owns one padded output texel
//   (f, Y, X) and its three channels, so nothing is atomic and the result
//   is deterministic and bit-equal to the plain version.
//   - A CTA owns a kTX x kTY tile of one face: kConsumerWarps warps, each
//     32 columns (one per lane) of kRows tile rows, and one producer warp.
//   - W moves through shared memory by TMA, in a ring of kStages stages
//     with full / empty mbarriers; a stage holds up to kG offsets of one
//     dy (dx = dxs .. dxs + kG - 1, dxs a multiple of 4), one box each of
//     kTY rows from row Y0 - dy of plane (f, p). TMA fills the box with
//     zeros outside [0, R)^2, so every lane runs the same offset loop: a
//     lane's terms outside the face are 0 * 0 = +0, and a running sum that
//     starts at +0 is never -0, so adding them leaves its bits unchanged.
//   - A box's first column must lie on 16 bytes (on the H100 a box from
//     column X0 - dx with dx % 4 != 0 never completed its barrier), so
//     each box is 36 columns wide from column X0 - dx rounded down to 4,
//     and lane x reads its weight at column x + (-dx & 3) of the box: a
//     shift known at compile time, because dxs is a multiple of 4.
//   - The offset range is cut per CTA to the offsets whose source box
//     touches the face ([dy0, dy1] x [dx0, dx1], uniform across the CTA):
//     at R = 64 most (tile, offset) pairs fall outside and are skipped.
//   - The g window of the tile ((kTY + P - 1) rows x (32 + P + 2) columns
//     rounded up to 4, from column X0 - (P - 1) rounded down to 4, x 3
//     channels) is one TMA box, zero-filled too.
//   - 32-bit indices; no per-weight address arithmetic beyond immediates.
#include "common.cuh"

#include <cuda.h>

using GigsEncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once per process through the runtime
// (null if it is missing).
inline GigsEncodeTiled gigs_encode_tiled() {
  static const GigsEncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<GigsEncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map of a dense f32 array [d2][d1][d0] (d0 innermost) read in
// boxes of b0 x b1 x b2 elements. Coordinates may lie outside the array
// (negative too): TMA fills those elements with zeros. d0 * 4 and b0 * 4
// must be multiples of 16 bytes, every box side at most 256.
inline cudaError_t gigs_tensor_map_f32_3d(CUtensorMap* map, const void* base,
                                          int d0, int d1, int d2, int b0,
                                          int b1, int b2) {
  const GigsEncodeTiled encode = gigs_encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d0) * 4,
                                 static_cast<cuuint64_t>(d0) * d1 * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(b0),
                             static_cast<cuuint32_t>(b1),
                             static_cast<cuuint32_t>(b2)};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// One TMA box of a 3-D tensor map into shared memory (128-byte aligned
// destination); its bytes complete on `bar`.
__device__ __forceinline__ void gigs_tma_load_3d(void* dst,
                                                 const CUtensorMap* map,
                                                 int x, int y, int z,
                                                 uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(gigs_smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z),
      "r"(gigs_smem_addr(bar))
      : "memory");
}


namespace {

constexpr int kTX = 32;                 // tile columns
constexpr int kTY = 8;                  // tile rows
constexpr int kConsumerWarps = 8;
constexpr int kWarpsX = kTX / 32;       // consumer warps across a row
constexpr int kRowWarps = kConsumerWarps / kWarpsX;
constexpr int kRows = kTY / kRowWarps;  // tile rows per consumer warp
constexpr int kG = 16;                  // offsets (boxes) per ring stage
constexpr int kStages = 4;
constexpr int kThreads = (kConsumerWarps + 1) * 32;
constexpr int kBoxW = kTX + 4;          // box columns: the tile's and the shift
constexpr int kBoxBytes = kBoxW * kTY * 4;   // what one box copy writes
// a box's place in the ring, rounded up to 128 bytes (TMA's alignment)
constexpr int kBoxFloats = (kBoxW * kTY + 31) & ~31;
constexpr int kStageFloats = kG * kBoxFloats;
static_assert(kTX % 32 == 0 && kConsumerWarps % kWarpsX == 0 &&
              kTY % kRowWarps == 0, "whole rows of whole warps");

__host__ __device__ inline int window_width(int P) {
  return (kTX + P + 2 + 3) & ~3;   // TMA rows are multiples of 16 bytes
}
__host__ __device__ inline int window_height(int P) { return kTY + P - 1; }
__host__ __device__ inline int window_bytes(int P) {
  return (3 * window_width(P) * window_height(P) * 4 + 127) & ~127;
}
// The ring, then the g window, then the barriers (full[kStages],
// empty[kStages], window).
__host__ __device__ inline int smem_bytes(int P) {
  return kStages * kStageFloats * 4 + window_bytes(P) +
         (2 * kStages + 1) * 8;
}

__global__ void __launch_bounds__(kThreads) patch_bwd_kernel(
    const __grid_constant__ CUtensorMap wmap,
    const __grid_constant__ CUtensorMap gmap, float* __restrict__ out, int R,
    int P) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* win = ring + kStages * kStageFloats;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + kStages * kStageFloats * 4 + window_bytes(P));
  uint64_t* empty = full + kStages;
  uint64_t* win_ready = empty + kStages;

  const int f = blockIdx.z;
  const int X0 = blockIdx.x * kTX;
  const int Y0 = blockIdx.y * kTY;
  // Offsets whose source box meets [0, R)^2 somewhere in this tile.
  const int dy0 = max(0, Y0 - R + 1), dy1 = min(P - 1, Y0 + kTY - 1);
  const int dx0 = max(0, X0 - R + 1), dx1 = min(P - 1, X0 + kTX - 1);
  const int dxa = dx0 & ~3;  // the first stage's dxs: a multiple of 4
  // the g window's first column, on 16 bytes, and the shift past it
  const int wx = (X0 - (P - 1)) & ~3;
  const int wsh = X0 - (P - 1) - wx;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      gigs_mbar_init(&full[s], 1);
      gigs_mbar_init(&empty[s], kConsumerWarps);
    }
    gigs_mbar_init(win_ready, 1);
    gigs_mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // Producer: one lane issues every copy, in the consumers' order.
    if (lane == 0) {
      gigs_mbar_arrive_expect_tx(win_ready, 3 * window_width(P) *
                                                window_height(P) * 4);
      gigs_tma_load_3d(win, &gmap, wx, Y0 - (P - 1), 3 * f, win_ready);
      const int plane0 = f * P * P;
      int it = 0;
      for (int dy = dy0; dy <= dy1; ++dy) {
        for (int dxs = dxa; dxs <= dx1; dxs += kG, ++it) {
          const int s = it % kStages;
          if (it >= kStages) gigs_mbar_wait(&empty[s], (it / kStages - 1) & 1);
          const int jlo = max(dx0 - dxs, 0), jhi = min(dx1 - dxs + 1, kG);
          gigs_mbar_arrive_expect_tx(&full[s], (jhi - jlo) * kBoxBytes);
          float* dst = ring + s * kStageFloats;
          for (int j = jlo; j < jhi; ++j)
            gigs_tma_load_3d(dst + j * kBoxFloats, &wmap,
                             (X0 - dxs - j) & ~3, Y0 - dy,
                             plane0 + dy * P + dxs + j, &full[s]);
        }
      }
    }
    return;
  }

  // Consumers: warp w owns columns 32 (w % kWarpsX) + lane of tile rows
  // w / kWarpsX + i kRowWarps.
  const int cx = (warp % kWarpsX) * 32 + lane;
  const int ry = warp / kWarpsX;
  const int WX = window_width(P);
  const int plane = WX * window_height(P);
  float acc[kRows][3];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i][0] = acc[i][1] = acc[i][2] = 0.0f;
  gigs_mbar_wait(win_ready, 0);
  int it = 0;
  for (int dy = dy0; dy <= dy1; ++dy) {
    for (int dxs = dxa; dxs <= dx1; dxs += kG, ++it) {
      const int s = it % kStages;
      gigs_mbar_wait(&full[s], (it / kStages) & 1);
      const int jlo = max(dx0 - dxs, 0), jhi = min(dx1 - dxs + 1, kG);
      const float* ws = ring + s * kStageFloats + cx;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = ry + i * kRowWarps;
        const float* gp =
            win + (r + P - 1 - dy) * WX + cx + P - 1 - dxs + wsh;
        const float* wp = ws + r * kBoxW;
        // Branch-free: a slot outside [jlo, jhi) (no box this round) adds
        // +0 whatever its product is, so every load can be hoisted.
#pragma unroll
        for (int j = 0; j < kG; ++j) {
          const bool live = j >= jlo && j < jhi;
          const float wv = wp[j * kBoxFloats + (-j & 3)];
          const float t0 = gp[-j] * wv;
          const float t1 = gp[plane - j] * wv;
          const float t2 = gp[2 * plane - j] * wv;
          acc[i][0] += live ? t0 : 0.0f;
          acc[i][1] += live ? t1 : 0.0f;
          acc[i][2] += live ? t2 : 0.0f;
        }
      }
      __syncwarp();
      if (lane == 0) gigs_mbar_arrive(&empty[s]);
    }
  }

  const int E = R + P - 1;
  const int X = X0 + cx;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int Y = Y0 + ry + i * kRowWarps;
    if (X < E && Y < E) {
      float* o = out + (3 * f * E + Y) * E + X;
      o[0] = acc[i][0];
      o[E * E] = acc[i][1];
      o[2 * E * E] = acc[i][2];
    }
  }
}

cudaError_t opt_in_smem(int device) {
  static unsigned long long done = 0;
  return gigs_opt_in_smem(device, done, patch_bwd_kernel);
}

}  // namespace

// R must be a multiple of 4 (TMA's row stride is a multiple of 16 bytes),
// W and g 16-byte aligned; shared memory grows with P (P <= ~110 fits).
GIGS_API int gigs_patch_bwd(int device, const void* W, const void* g,
                            void* out, int R, int P, int h, void* stream) {
  (void)h;  // P = 2h + 1
  cudaError_t err = gigs_use_device(device);
  if (err == cudaSuccess) err = opt_in_smem(device);
  CUtensorMap wmap, gmap;
  if (err == cudaSuccess)
    err = gigs_tensor_map_f32_3d(&wmap, W, R, R, 6 * P * P, kBoxW, kTY, 1);
  if (err == cudaSuccess)
    err = gigs_tensor_map_f32_3d(&gmap, g, R, R, 18, window_width(P),
                                 window_height(P), 3);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int E = R + P - 1;
  const dim3 grid((E + kTX - 1) / kTX, (E + kTY - 1) / kTY, 6);
  patch_bwd_kernel<<<grid, kThreads, smem_bytes(P),
                     static_cast<cudaStream_t>(stream)>>>(
      wmap, gmap, static_cast<float*>(out), R, P);
  GIGS_RETURN_LAUNCH_STATUS();
}

// Registers, shared memory and resident blocks per SM at a level's launch
// shape (gigs_kernel_resources in common.cuh).
GIGS_API int gigs_patch_bwd_resources(int device, int R, int P, int* out) {
  (void)R;
  cudaError_t err = gigs_use_device(device);
  if (err == cudaSuccess) err = opt_in_smem(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return gigs_kernel_resources(patch_bwd_kernel, kThreads, smem_bytes(P),
                               out);
}
'''

# name -> [(file, old text or None, new text)]
VARIANTS = {
    "kept": [],
    # ring depth
    "stages3": [const(STAGES, 3)],
    "stages4": [const(STAGES, 4)],
    # at most 4 or 8 consumer warps (128 or 256 columns) per CTA
    "warps_x4": [const(WARPS_X, 4)],
    "warps_x8": [const(WARPS_X, 8)],
    # the offset loop unrolled 4 or 16 times
    "unroll4": [sub(UNROLL, UNROLL.replace("unroll 8", "unroll 4"))],
    "unroll16": [sub(UNROLL, UNROLL.replace("unroll 8", "unroll 16"))],
    "tma_tiles": [sub(None, TMA_TILES)],
    # each warp walks only the offsets at which one of its lanes reaches
    # the face, with gaps of min(P - 1, 31): bit-equal, but built with
    # `#pragma unroll 16`, or with its loop written from k0 to k1, it
    # faulted (illegal address) on the card; not kept
    "warp_cut": [sub(GAP, "  c.G = (min(P - 1, 31) + 3) & ~3;"),
                 sub(CONSUMER_X, WARP_CUT),
                 sub(UNROLL, "#pragma unroll 8\n    for (int m = 0; m < nk; "
                     "++m) {\n      const int k = k0 + m;")],
    # diagnostics (not bit-equal): the copies without the arithmetic, and
    # the arithmetic on whatever the ring holds, without W and g copies
    "no_compute": [sub(FMAS, "      (void)wv;\n")],
    "no_copies": [sub(EXPECT, "      if (lane == 0) gigs_mbar_arrive(&full[s]);"),
                  sub(COPIES, COPIES.replace("q < ndx + 3;",
                                             "q < ndx + 3 && dy < 0;"))],
}


def build(ck, root: str, baseline: str | None):
    """Compile every variant (and the baseline) in parallel; returns
    {name: (CDLL, path)}."""
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
               os.path.join(d, "patch_bwd.cu")]
        procs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        regs = [ln.split(":", 1)[1].strip() for ln in out.splitlines()
                if "registers" in ln]
        print(f"[build] {name}: {regs}", flush=True)
        lib = ctypes.CDLL(so)
        lib.gigs_patch_bwd.argtypes = ck.signatures()["gigs_patch_bwd"]
        libs[name] = (lib, so)
    return libs


def sass_per_weight(ck, so: str, out_dir: str, name: str) -> dict:
    """The kernel's SASS (written to out_dir) and its instructions per
    weight: first to last FMUL over a third of the FMULs."""
    sass = subprocess.run(
        [os.path.join(os.path.dirname(ck.nvcc_path()), "cuobjdump"), "-sass",
         so], capture_output=True, text=True).stdout
    with open(os.path.join(out_dir, f"patch_bwd_{name}.sass"), "w") as f:
        f.write(sass)
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     sass)
    fmul = [i for i, op in enumerate(ops) if op.startswith("FMUL")]
    if not fmul:
        return dict(instructions=len(ops))
    span = ops[fmul[0]:fmul[-1] + 1]
    weights = len(fmul) / 3.0
    counts = {}
    for op in span:
        key = op.split(".")[0]
        counts[key] = counts.get(key, 0) + 1
    return dict(instructions=len(ops), loop_instructions=len(span),
                weights_in_loop=weights,
                per_weight=len(span) / weights, loop_ops=counts)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--baseline", default="")
    ap.add_argument("--sass", default="")
    ap.add_argument("--only", default="",
                    help="comma-separated variants to build (default all)")
    args = ap.parse_args()
    if args.only:
        keep = args.only.split(",")
        for name in list(VARIANTS):
            if name not in keep:
                del VARIANTS[name]
    import torch
    if not torch.cuda.is_available():
        sys.exit("patch_variants: needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from gi_gs_tpu_torch.ops import cubemap as cm
    from gi_gs_tpu_torch.ops import cuda_kernels as ck

    dev = torch.device("cuda")
    work = tempfile.mkdtemp(prefix="patch_variants_")
    try:
        libs = build(ck, work, args.baseline or None)
        sass = {}
        if args.sass:
            os.makedirs(args.sass, exist_ok=True)
            for name in ("kept", "baseline"):
                if name in libs:
                    sass[name] = sass_per_weight(ck, libs[name][1], args.sass,
                                                 name)
                    print(f"SASS {name}: {sass[name]}", flush=True)
        spec, arrays = cm.build_prefilter_tables(256, device=dev)
        ops, _ = cm.level_operators(spec, arrays)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        levels = []
        for sp, op in zip(spec, ops):
            if sp[0] == "dense":
                continue
            h, Wt = sp[1], op[1]
            R = Wt.shape[-1]
            g = torch.randn(6, 3, R, R, device=dev, generator=gen)
            E = R + 2 * h
            levels.append(dict(R=R, P=2 * h + 1, h=h, W=Wt, g=g,
                               out=torch.empty(6, 3, E, E, device=dev),
                               plain=cm._patch_bwd_plain(Wt, g, h)))
        stream = lambda: torch.cuda.current_stream().cuda_stream

        def launch(lib, lv):
            err = lib.gigs_patch_bwd(0, lv["W"].data_ptr(), lv["g"].data_ptr(),
                                     lv["out"].data_ptr(), lv["R"], lv["P"],
                                     lv["h"], stream())
            assert err == 0, err

        # each design once on every level, checked against the plain
        # version before any is timed (a design that faults is named here)
        same = {}
        for name, (lib, _) in libs.items():
            print(f"checking {name}", flush=True)
            for lv in levels:
                lv["out"].fill_(float("nan"))
                launch(lib, lv)
                torch.cuda.synchronize()
                same[name, lv["R"]] = bool(torch.equal(lv["out"], lv["plain"]))
        times = {name: {lv["R"]: [] for lv in levels} for name in libs}
        for _ in range(args.rounds):
            for name, (lib, _) in libs.items():
                for lv in levels:
                    times[name][lv["R"]].append(
                        cs.cuda_ms(lambda: launch(lib, lv), args.reps))
        results = {"sass": sass}
        for name, (lib, _) in libs.items():
            row = {}
            for lv in levels:
                ms = times[name][lv["R"]]
                nbytes = (lv["W"].numel() + lv["g"].numel()
                          + lv["out"].numel()) * 4
                b_ms = cs.bound(nbytes, 0.0)[0]
                row[lv["R"]] = dict(
                    P=lv["P"], ms_min=min(ms), ms_median=float(np.median(ms)),
                    ms=ms, bound_ms=b_ms, bound_share=b_ms / min(ms),
                    bit_equal_to_plain=same[name, lv["R"]])
                print(f"{name} R={lv['R']} P={lv['P']}: min {min(ms):.4f} ms, "
                      f"median {np.median(ms):.4f} ms, bound {b_ms:.4f} ms "
                      f"({b_ms / min(ms):.1%}); bit-equal to the plain "
                      f"version: {row[lv['R']]['bit_equal_to_plain']}",
                      flush=True)
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
