#!/usr/bin/env python3
"""Time design variants of the port's expand kernel on one NVIDIA GPU and
check their outputs against the plain expansion.

    python3 tools/expand_variants.py [--seed 0] [--reps 50] [--rounds 5]
                                     [--baseline DIR]

Each variant is the source of gi_gs_tpu_torch/csrc/expand.cu with one
design choice changed by a text substitution (VARIANTS below; `kept` is
the source as it is), built into a library of its own with the port's
nvcc flags. `--baseline DIR` also builds a checkout's expand.cu as it is
(for example the parent commit, unpacked with `git archive`). Every design
expands view 0 of chip_smoke.py's serving scene (300k Gaussians in
capacity 2^19, 800x800, the default RasterConfig), timed with CUDA events,
every design once per round for `--rounds` rounds in turn (min and
median), and its tile, depth and gid rows are compared with
`_expand_plain`'s. `no_cull` and `search_twice` are diagnostics: the
first drops the cull (its rows differ), the second runs the search for
the first Gaussian twice, the second time after the first has ended.
Prints one line per design, the card's name, power limit and SM clocks,
and last a JSON object of every number. Needs a card; builds nothing into
the package's own cache.

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
SOURCES = ("common.cuh", "expand.cu")
DUMMY_SKIP = """  if (!in_range || rw < 1) {  // a dummy slot: no tile, whatever the cull
    tile_out[j] = num_tiles;
    depth_out[j] = in_range ? s_depth[i] : INFINITY;
    return;
  }
"""
KEEP = "  const bool keep = !psd || (op * expf(fmax) >= alpha_min);"
SEARCH = "    if (t == 0) s_g0 = lo;"
SEARCH_AGAIN = """const int found = __shfl_sync(0xffffffffu, lo, 0);
    lo = 0;
    int hi2 = min(n - 1, j0 + (found < 0));  // after the first, same range
    while (lo < hi2) {
      const int step = (hi2 - lo + 32) >> 5;
      const int pt = lo + t * step;
      const unsigned le =
          __ballot_sync(0xffffffffu, pt <= hi2 && offsets[pt] <= j0);
      lo += (31 - __clz(le)) * step;
      hi2 = min(hi2, lo + step - 1);
    }
    if (t == 0) s_g0 = lo;"""
TILE_OUT = "  tile_out[j] = keep ? tile : num_tiles;"
DEPTH_OUT = "  depth_out[j] = s_depth[i];"

# name -> [(old text, new text)] in expand.cu
VARIANTS = {
    "kept": [],
    # every in-range slot runs the cull (the design before the skip)
    "no_dummy_skip": [
        (DUMMY_SKIP, ""),
        ("  const int dy = local / rw;", "  const int rw_safe = rw > 1 ? rw : 1;\n"
         "  const int dy = local / rw_safe;"),
        ("  const int dx = local - dy * rw;", "  const int dx = local - dy * "
         "rw_safe;"),
        (TILE_OUT, "  tile_out[j] = (in_range && keep && rw >= 1) ? tile : "
         "num_tiles;"),
        (DEPTH_OUT, "  depth_out[j] = in_range ? s_depth[i] : INFINITY;")],
    # diagnostics: no cull (every live slot kept; rows differ), and the
    # search run twice (the second from the first's result; rows equal):
    # each measures what its part costs
    "no_cull": [(KEEP, "  const bool keep = psd || !psd;")],
    "search_twice": [(SEARCH, SEARCH + "\n    " + SEARCH_AGAIN)],
}


def build(ck, root: str, baseline: str | None):
    """Compile every variant (and the baseline) in parallel; returns
    {name: CDLL}."""
    csrc = os.path.join(REPO, *CSRC)
    jobs = []
    for name, subs in VARIANTS.items():
        d = os.path.join(root, name)
        os.makedirs(d)
        text = {f: open(os.path.join(csrc, f)).read() for f in SOURCES}
        for old, new in subs:
            if old not in text["expand.cu"]:
                raise RuntimeError(f"{name}: {old!r} is not in expand.cu")
            text["expand.cu"] = text["expand.cu"].replace(old, new)
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
               os.path.join(d, "expand.cu")]
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
        lib.gigs_expand.argtypes = ck.signatures()["gigs_expand"]
        libs[name] = lib
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--baseline", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("expand_variants: needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from gi_gs_tpu_torch import config as config_mod
    from gi_gs_tpu_torch.models.gaussians import params_from_numpy
    from gi_gs_tpu_torch.ops import cuda_kernels as ck
    from gi_gs_tpu_torch.ops.rasterize import binning
    from gi_gs_tpu_torch.ops.rasterize.preprocess import preprocess
    from gi_gs_tpu_torch.scene.dataset import load_scene

    dev = torch.device("cuda")
    work = tempfile.mkdtemp(prefix="expand_variants_")
    try:
        libs = build(ck, work, args.baseline or None)
        rng = np.random.RandomState(args.seed)     # chip_smoke's scene
        cs.write_scene(os.path.join(work, "scene"), rng, cs.N_VIEWS, cs.SIZE)
        fields = cs.gaussian_fields(rng, cs.N_GAUSSIANS, cs.CAPACITY)
        cam = load_scene(os.path.join(work, "scene"),
                         eval_split=True).test_cameras[0].camera(dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    p = params_from_numpy(fields, 3, 3, device=dev)
    rc = config_mod.Config().raster
    H, W = cam.height, cam.width
    with torch.inference_mode():
        pre = preprocess(p.xyz, p.get_covariance(), cam.w2c, cam.full_proj,
                         cam.tanfovx, cam.tanfovy, W, H, rc,
                         opacity=p.get_opacity())
        ty, tx = rc.grid(H, W)
        cap, n, fl = rc.cap_instances, pre.depth.shape[0], pre.flat
        offsets = binning._offsets(pre)
        cols = [c.contiguous() for c in (
            fl.rmin_x, fl.rmin_y, fl.rmax_x, pre.tiles_touched, pre.depth,
            fl.px, fl.py, fl.cxx, fl.cxy, fl.cyy, pre.opacity)]
        plain = binning._expand_plain(pre, H, W, rc)[:3]
        outs = [torch.empty(cap, dtype=t, device=dev)
                for t in (torch.int32, torch.float32, torch.int32)]
        stream = torch.cuda.current_stream().cuda_stream

        def launch(lib):
            err = lib.gigs_expand(
                0, offsets.data_ptr(), n, *[c.data_ptr() for c in cols], cap,
                tx, ty * tx, rc.tile_w, rc.tile_h, rc.alpha_min,
                *[o.data_ptr() for o in outs], stream)
            assert err == 0, err

        times = {name: [] for name in libs}
        for _ in range(args.rounds):
            for name, lib in libs.items():
                times[name].append(cs.cuda_ms(lambda: launch(lib), args.reps))
        results = dict(cap=cap, gaussians=n, instances=int(offsets[-1]))
        for name, lib in libs.items():
            for o in outs:
                o.fill_(-1)
            launch(lib)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(outs, plain))
            ms = times[name]
            results[name] = dict(ms_min=min(ms), ms_median=float(np.median(ms)),
                                 ms=ms, equal_to_plain=same)
            print(f"{name}: min {min(ms):.4f} ms, median {np.median(ms):.4f} "
                  f"ms; rows equal to the plain version's: {same}",
                  flush=True)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(cs.card_line(), flush=True)
    print(f"SM clock, max SM clock: {clocks.strip()}", flush=True)
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
