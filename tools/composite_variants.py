#!/usr/bin/env python3
"""Time variants of the port's compositing kernels on one NVIDIA GPU.

    python3 tools/composite_variants.py [--seed 0] [--reps 20]

Each variant is the source of gi_gs_tpu_torch/csrc/composite_{fwd,bwd}.cu
and composite_walk.cuh with one design choice undone by a text
substitution (VARIANTS below; `no_walk` skips the walk itself and gives
wrong outputs). All are built in parallel with the port's
nvcc flags into libraries of their own and timed with CUDA events on view
0 of chip_smoke.py's serving scene (300k Gaussians, 800x800, tile 16x64,
cap_tile 4096), then on the same view with every opacity at sigmoid(-4.6)
~ 0.01, where no pixel saturates (as on the phase-1 views after an opacity
reset). The backward gets random cotangents. Each variant's outputs are
compared bit for bit with the unchanged kernels'. Prints one line per
variant and, last, the card's name and power limit and a JSON object of
every time. Needs a card; builds nothing into the package's own cache.

A one-off experiment kept to back the design-variant times in PERF.md:
the substitutions match the kernels' source text line for line, so an
edit of those lines makes the tool raise (it names the variant and the
missing text) until its VARIANTS are rewritten. Its scene setup and the
C entries' argument lists are copies of chip_smoke.py's and
ops/rasterize/composite.py's, not shared with them.
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
NO_CULL = [("float ylo = 0.0f, yhi = 0.0f;",
            "float ylo = -INFINITY, yhi = INFINITY;"),
           ("k < nb && subtile_keep(rows[k], s, alpha_min, ylo, yhi)",
            "k < nb")]
# name -> [(file, old text, new text)]
VARIANTS = {
    "current": [],
    # the forward leaves the walk at its done flag (as the one-block-per-
    # tile kernel did): lanes that reject run ahead of lanes that blend
    # until the batch's barrier
    "fwd_break_on_done": [("composite_fwd.cu",
                           "        done = true;\n        continue;",
                           "        done = true;\n        break;")],
    # the forward's warps vote at every row and leave the batch once all
    # their pixels are done
    "fwd_vote": [("composite_fwd.cu", "for (int j = 0; j < n_keep; ++j) {",
                  "for (int j = 0; j < n_keep && !__all_sync(kFull, done); "
                  "++j) {")],
    # both kernels walk every row of the tile (no sub-tile cull)
    "no_cull": [("composite_walk.cuh", a, b) for a, b in NO_CULL],
    # no per-warp skip of rows whose extent misses the warp's pixel rows
    "no_warp_skip": [("composite_fwd.cu",
                      "if (done || yb.y < wrows.x || yb.x > wrows.y) continue;",
                      "if (done) continue;"),
                     ("composite_bwd.cu",
                      "if (yb.y < wrows.x || yb.x > wrows.y) {",
                      "if (false) {")],
    # both kernels gather, cull and meet their barriers but walk no row
    # (outputs wrong): the cost of everything but the walk
    "no_walk": [(f, "for (int j = 0; j < n_keep; ++j) {",
                 "for (int j = 0; j < 0; ++j) {")
                for f in ("composite_fwd.cu", "composite_bwd.cu")],
    "fwd_batch64": [("composite_fwd.cu", "constexpr int kBatch = 256;",
                     "constexpr int kBatch = 64;")],
    "fwd_batch128": [("composite_fwd.cu", "constexpr int kBatch = 256;",
                      "constexpr int kBatch = 128;")],
    "bwd_batch32": [("composite_bwd.cu", "constexpr int kBatch = 64;",
                     "constexpr int kBatch = 32;")],
    "bwd_batch128": [("composite_bwd.cu", "constexpr int kBatch = 64;",
                      "constexpr int kBatch = 128;")],
    # a warp with one contributing lane stores that lane's row as it is,
    # without the transpose-reduce
    "bwd_lone_lane": [("composite_bwd.cu",
                       "        if (__ballot_sync(kFull, contrib) == 0u) {",
                       "        const unsigned bal = __ballot_sync(kFull, "
                       "contrib);\n        if (bal == 0u) {"),
                      ("composite_bwd.cu",
                       "        const float col = transpose_reduce(v, lane);",
                       "        if (__popc(bal) == 1) {\n"
                       "          if (contrib) {\n"
                       "            for (int c = 0; c < kRow; ++c)\n"
                       "              sm.wpart[warp][j][c] = v[c];\n"
                       "            sm.wflag[warp][j] = 1;\n"
                       "          }\n"
                       "          continue;\n"
                       "        }\n"
                       "        const float col = transpose_reduce(v, lane);")],
}
SOURCES = ("common.cuh", "composite_walk.cuh", "composite_fwd.cu",
           "composite_bwd.cu")


def build(ck, root: str):
    """Write and compile every variant; returns {name: CDLL}."""
    csrc = os.path.join(REPO, "gi_gs_tpu_torch", "csrc")
    procs = []
    for name, subs in VARIANTS.items():
        d = os.path.join(root, name)
        os.makedirs(d)
        text = {f: open(os.path.join(csrc, f)).read() for f in SOURCES}
        for f, old, new in subs:
            if old not in text[f]:
                raise RuntimeError(f"{name}: {old!r} is not in {f}")
            text[f] = text[f].replace(old, new)
        for f, t in text.items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(t)
        so = os.path.join(d, "lib.so")
        cmd = [ck.nvcc_path(), *ck.NVCC_FLAGS, "-shared", "-o", so,
               os.path.join(d, "composite_fwd.cu"),
               os.path.join(d, "composite_bwd.cu")]
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
        for fn in ("gigs_composite_fwd", "gigs_composite_bwd"):
            getattr(lib, fn).argtypes = ck.signatures()[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("composite_variants: needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from gi_gs_tpu_torch import config as config_mod
    from gi_gs_tpu_torch.models.gaussians import params_from_numpy
    from gi_gs_tpu_torch.ops import cuda_kernels as ck
    from gi_gs_tpu_torch.ops.rasterize import binning, composite
    from gi_gs_tpu_torch.ops.rasterize.preprocess import preprocess
    from gi_gs_tpu_torch.scene.dataset import load_scene

    dev = torch.device("cuda")
    work = tempfile.mkdtemp(prefix="composite_variants_")
    try:
        libs = build(ck, os.path.join(work, "build"))
        rng = np.random.RandomState(args.seed)     # chip_smoke's scene
        cs.write_scene(os.path.join(work, "scene"), rng, cs.N_VIEWS, cs.SIZE)
        fields = cs.gaussian_fields(rng, cs.N_GAUSSIANS, cs.CAPACITY)
        cam = load_scene(os.path.join(work, "scene"),
                         eval_split=True).test_cameras[0].camera(dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    params = params_from_numpy(fields, 3, 3, device=dev)
    rc = config_mod.Config().raster
    H, W = cam.height, cam.width
    grid = rc.grid(H, W)
    T, P = grid[0] * grid[1], rc.pixels_per_tile
    n_max = rc.chunks_per_tile * rc.chunk
    stream = lambda: torch.cuda.current_stream().cuda_stream
    times = {}
    for label, opacity_logit in (("view0", None), ("view0_op0.01", -4.6)):
        if opacity_logit is not None:
            with torch.no_grad():
                params.opacity.fill_(opacity_logit)
        with torch.inference_mode():
            op = params.get_opacity()
            pre = preprocess(params.xyz, params.get_covariance(), cam.w2c,
                             cam.full_proj, cam.tanfovx, cam.tanfovy, W, H,
                             rc, opacity=op)
            b = binning.bin_and_sort(pre, H, W, rc)
            table = composite.composite_table(
                pre, op, params.colors_from_sh(cam.cam_pos),
                params.get_normal(), params.get_albedo(),
                params.get_roughness(), params.get_metallic()).contiguous()
        ts = b.tile_start.to(torch.int32).contiguous()
        tc = b.tile_count.to(torch.int32).contiguous()
        gen = torch.Generator(device=dev).manual_seed(1)
        g_acc = torch.randn((T, 16, P), device=dev, generator=gen)
        g_t = torch.randn((T, P), device=dev, generator=gen)
        ref = None
        for name, lib in libs.items():
            acc = torch.empty((T, 16, P), device=dev)
            fin = torch.empty((T, P), device=dev)
            rows = torch.zeros((b.ids.numel(), 21), device=dev)

            def fwd():
                err = lib.gigs_composite_fwd(
                    0, table.data_ptr(), b.ids.data_ptr(), ts.data_ptr(),
                    tc.data_ptr(), T, 0, n_max, grid[1], rc.tile_w,
                    rc.tile_h, rc.alpha_clamp, rc.alpha_min, rc.t_min,
                    acc.data_ptr(), fin.data_ptr(), stream())
                assert err == 0, err

            fwd_ms = cs.cuda_ms(fwd, args.reps)
            acc4 = acc[:, :4].contiguous()

            def bwd():
                err = lib.gigs_composite_bwd(
                    0, table.data_ptr(), b.ids.data_ptr(), ts.data_ptr(),
                    tc.data_ptr(), acc4.data_ptr(), fin.data_ptr(),
                    g_acc.data_ptr(), g_t.data_ptr(), T, 0, n_max, grid[1],
                    rc.tile_w, rc.tile_h, H, W, rc.alpha_clamp, rc.alpha_min,
                    rc.t_min, rows.data_ptr(), stream())
                assert err == 0, err

            bwd_ms = cs.cuda_ms(bwd, args.reps)
            if ref is None:
                ref = (acc.clone(), fin.clone(), rows.clone())
            same = (torch.equal(acc, ref[0]) and torch.equal(fin, ref[1])
                    and torch.equal(rows, ref[2]))
            times[f"{label}/{name}"] = dict(fwd_ms=fwd_ms, bwd_ms=bwd_ms,
                                            bit_equal_to_current=same)
            print(f"{label} {name}: composite_fwd {fwd_ms:.3f} ms, "
                  f"composite_bwd {bwd_ms:.3f} ms, outputs bit-equal to "
                  f"the current kernels': {same}", flush=True)
    print(cs.card_line(), flush=True)
    print(json.dumps(times), flush=True)


if __name__ == "__main__":
    main()
