#!/usr/bin/env python3
"""Time design variants of the port's two screen-space marches on one
NVIDIA GPU, count their lane efficiency, and check their outputs bit for
bit.

    python3 tools/march_variants.py [--seed 0] [--reps 10] [--rounds 3]
                                    [--baseline DIR] [--sass DIR]

Each variant is the source of gi_gs_tpu_torch/csrc/gi_march.cu,
gi_march_coherent.cu and march_walk.cuh with one design choice changed by a
text substitution (VARIANTS below; `kept` is the source as it is), built
into a library of its own with the port's nvcc flags. `--baseline DIR` also
builds a
checkout's kernels as they are (for example the parent commit, unpacked
with `git archive`), called through the signatures before the coherent
kernel built its own keys: its coherent march reads the keys of the plain
`centre_offset_table` on the card, whose time is then added ("keys from a
table"); the `prepass` design is a keys-only launch of the kept kernel
followed by that baseline kernel on the keys it wrote. All run on view 0 of
chip_smoke.py's serving scene (300k Gaussians, 800x800, default GIParams),
each march as SSAO (no RGB) plus SSR (random RGB) on the G-buffer of
chip_smoke's phase 4, timed with CUDA events, every design once per
round for `--rounds` rounds in turn (min and median). Each variant's
occlusion and indirect sums are compared bit for bit with the kept
kernels'. The counting build (`count_lockstep`) gives the lock-step
walk's live samples over its issued lane-steps. `--sass DIR` writes the
SASS of the kept library there (cuobjdump), for counting instructions
per live sample. Prints one line per variant, the card's name, power
limit and SM clocks, and last a JSON object of every number. Needs a
card; builds nothing into the package's own cache.

A one-off experiment kept to back the design-variant times in PERF.md:
the substitutions match the kernels' source text line for line, so an
edit of those lines makes the tool raise (it names the variant and the
missing text) until its VARIANTS are rewritten.
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
SOURCES = ("common.cuh", "march_walk.cuh", "gi_march.cu",
           "gi_march_coherent.cu")
KERNELS = SOURCES[2:]
# march_walk.cuh's lock-step walk, from its first line to its end
KEPT_WALK = """  const float fstart = static_cast<float>(start);
  for (int d = 0; d < nd; ++d) {
    m.dir(d);
    float fj = fstart;
    for (int jj = 0; jj < ns; ++jj, fj += 1.0f)
      if (m.sample(jj, fj)) break;
  }
}"""
# one loop over the flattened (direction, step) sequence: a lane whose ray
# ends goes on to its next direction at once
PER_LANE_WALK = """  const float fstart = static_cast<float>(start);
  if (nd <= 0 || ns <= 0) return;
  int d = 0, jj = 0;
  float fj = fstart;
  m.dir(0);
  while (true) {
    if (m.sample(jj, fj) || ++jj == ns) {
      if (++d == nd) break;
      jj = 0;
      fj = fstart;
      m.dir(d);
    } else {
      fj += 1.0f;
    }
  }
}"""
# the lock-step walk counting [0] samples taken (live lane-steps) and [1]
# loop iterations issued per warp, times 32, into g_counts
COUNTING_WALK = """  const float fstart = static_cast<float>(start);
  unsigned long long live = 0, issued = 0;
  unsigned lane;
  asm("mov.u32 %0, %%laneid;" : "=r"(lane));
  for (int d = 0; d < nd; ++d) {
    m.dir(d);
    float fj = fstart;
    for (int jj = 0; jj < ns; ++jj, fj += 1.0f) {
      ++live;
      if (lane == static_cast<unsigned>(__ffs(__activemask()) - 1))
        issued += 32;
      if (m.sample(jj, fj)) break;
    }
  }
  atomicAdd(&g_counts[0], live);
  atomicAdd(&g_counts[1], issued);
}"""
WALK_DECL = "template <class March>\n__device__ __forceinline__ void walk("
# copies a source's lane counts to `out` (2 x uint64) and resets them
COUNT_ENTRY = """
GIGS_API int {name}(void* out) {{
  cudaError_t err = cudaMemcpyFromSymbol(
      out, gigs_march::g_counts, 2 * sizeof(unsigned long long));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[2] = {{0, 0}};
  return static_cast<int>(
      cudaMemcpyToSymbol(gigs_march::g_counts, zero, sizeof(zero)));
}}
"""
EXACT_CTA = "constexpr int kBX = 16;\nconstexpr int kBY = 16;"
GATHER = "  gather_offsets(soff, rank, total, tid);\n"


def exact_cta(bx: int, by: int):
    return [("gi_march.cu", EXACT_CTA,
             f"constexpr int kBX = {bx};\nconstexpr int kBY = {by};")]


# name -> [(file, old text, new text)]; old text None appends new text
VARIANTS = {
    "kept": [],
    "per_lane": [("march_walk.cuh", KEPT_WALK, PER_LANE_WALK)],
    "exact_32x8": exact_cta(32, 8),
    "exact_8x32": exact_cta(8, 32),
    "exact_32x4": exact_cta(32, 4),
    "exact_per_lane_32x8": [("march_walk.cuh", KEPT_WALK, PER_LANE_WALK),
                            *exact_cta(32, 8)],
    # each CTA builds all its block's keys; no cluster
    "coherent_no_cluster": [
        ("gi_march_coherent.cu", "constexpr int kCluster = kCTAs;",
         "constexpr int kCluster = 1;"),
        ("gi_march_coherent.cu", "__cluster_dims__(1, kCTAs, 1)", ""),
        ("gi_march_coherent.cu", GATHER, "  __syncthreads();\n")],
    # the coherent kernel writes its keys and returns: a keys-only pre-pass
    "keys_only": [("gi_march_coherent.cu", GATHER, "  return;\n")],
    "count_lockstep": [
        ("march_walk.cuh", KEPT_WALK, COUNTING_WALK),
        ("march_walk.cuh", WALK_DECL,
         "static __device__ unsigned long long g_counts[2];\n\n"
         + WALK_DECL),
        ("gi_march.cu", None, COUNT_ENTRY.format(name="gigs_gi_march_count")),
        ("gi_march_coherent.cu", None,
         COUNT_ENTRY.format(name="gigs_gi_march_coherent_count"))],
}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the coherent march's C entry before it built its own keys
BASELINE_COHERENT = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _I,
                     _I, _P, _P, _P]


def build(ck, root: str, baseline: str | None):
    """Compile every variant (and the baseline) in parallel; returns
    {name: CDLL}."""
    csrc = os.path.join(REPO, *CSRC)
    jobs = []
    for name, subs in VARIANTS.items():
        d = os.path.join(root, name)
        os.makedirs(d)
        text = {f: open(os.path.join(csrc, f)).read() for f in SOURCES}
        for f, old, new in subs:
            if old is None:
                text[f] += new
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
               *[os.path.join(d, k) for k in KERNELS]]
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
        lib.gigs_gi_march.argtypes = ck.signatures()["gigs_gi_march"]
        lib.gigs_gi_march_coherent.argtypes = (
            BASELINE_COHERENT if name == "baseline"
            else ck.signatures()["gigs_gi_march_coherent"])
        if name.startswith("count"):
            for fn in ("gigs_gi_march_count", "gigs_gi_march_coherent_count"):
                getattr(lib, fn).argtypes = [_P]
        libs[name] = lib
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--baseline", default="")
    ap.add_argument("--sass", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("march_variants: needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from gi_gs_tpu_torch import config as config_mod
    from gi_gs_tpu_torch.models.gaussians import params_from_numpy
    from gi_gs_tpu_torch.ops import cuda_kernels as ck
    from gi_gs_tpu_torch.ops import screen_space as ss
    from gi_gs_tpu_torch.renderer import render
    from gi_gs_tpu_torch.scene.dataset import load_scene

    dev = torch.device("cuda")
    work = tempfile.mkdtemp(prefix="march_variants_")
    try:
        libs = build(ck, work, args.baseline or None)
        if args.sass:
            os.makedirs(args.sass, exist_ok=True)
            sass = subprocess.run(
                [os.path.join(os.path.dirname(ck.nvcc_path()), "cuobjdump"),
                 "-sass", os.path.join(work, "kept.so")],
                capture_output=True, text=True).stdout
            with open(os.path.join(args.sass, "march_kept.sass"), "w") as f:
                f.write(sass)
        rng = np.random.RandomState(args.seed)     # chip_smoke's scene
        cs.write_scene(os.path.join(work, "scene"), rng, cs.N_VIEWS, cs.SIZE)
        fields = cs.gaussian_fields(rng, cs.N_GAUSSIANS, cs.CAPACITY)
        cam = load_scene(os.path.join(work, "scene"),
                         eval_split=True).test_cameras[0].camera(dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    params = params_from_numpy(fields, 3, 3, device=dev)
    cfg = config_mod.Config()
    gi = cfg.gi
    H, W = cam.height, cam.width
    with torch.inference_mode():
        res = render(cam, params, torch.zeros(3, device=dev), cfg.raster, gi,
                     inference=True, pad_normal=True)
    nv, pos = res["out_normal_view"].contiguous(), res["depth_pos"]
    rgb = torch.rand(3, H, W, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    tab = torch.as_tensor(ss.direction_table(gi)[0], device=dev)
    nd, ns = tab.shape[0], gi.step - gi.start
    nby, nbx = -(-H // ss.BH), -(-W // ss.BW)
    f32 = lambda v: float(np.float32(v))
    fx, fy, zk = f32(cam.fx), f32(cam.fy), f32(gi.radius / gi.step)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    keys = {r is None: torch.empty((nby, nbx, nd, ns), dtype=torch.int32,
                                   device=dev) for r in (None, rgb)}
    outs = {r is None: (torch.empty(H, W, device=dev),
                        torch.zeros(3, H, W, device=dev)) for r in (None, rgb)}
    ptr = lambda t: None if t is None else t.data_ptr()

    def exact(lib, r):
        o, d = outs[r is None]
        err = lib.gigs_gi_march(
            0, nv.data_ptr(), pos.data_ptr(), ptr(r), tab.data_ptr(), nd, H,
            W, fx, fy, W / 2.0, H / 2.0, zk, gi.bias, gi.thick, gi.start,
            gi.step, o.data_ptr(), ptr(None if r is None else d), stream())
        assert err == 0, err

    def coherent(lib, r, keys_out=None):
        o, d = outs[r is None]
        err = lib.gigs_gi_march_coherent(
            0, nv.data_ptr(), pos.data_ptr(), ptr(r), tab.data_ptr(), nd, H,
            W, fx, fy, W / 2.0, H / 2.0, zk, gi.bias, gi.thick, gi.start,
            gi.step, o.data_ptr(), ptr(None if r is None else d),
            ptr(keys_out), stream())
        assert err == 0, err

    def baseline_coherent(lib, r, k):
        o, d = outs[r is None]
        err = lib.gigs_gi_march_coherent(
            0, nv.data_ptr(), pos.data_ptr(), ptr(r), tab.data_ptr(),
            k.data_ptr(), nd, ns, H, W, zk, gi.bias, gi.thick, gi.start,
            gi.step, o.data_ptr(), ptr(None if r is None else d), stream())
        assert err == 0, err

    def table():
        return ss.centre_offset_table(nv, pos, tab, cam.fx, cam.fy, gi)

    def outputs(fn):
        got = []
        for r in (None, rgb):
            fn(r)
            got.extend(t.clone() for t in outs[r is None])
        torch.cuda.synchronize()
        return got

    def pair_ms(fn):
        return sum(cs.cuda_ms(lambda: fn(r), args.reps) for r in (None, rgb))

    results, ref = {}, {}
    keys_table = table()
    for kind in ("exact", "coherent"):
        designs = {}
        for name, lib in libs.items():
            if name.startswith("count") or name == "keys_only":
                continue
            if name == "baseline":
                designs["baseline" if kind == "exact" else "baseline_table"] = (
                    (lambda r, lib=lib: exact(lib, r)) if kind == "exact" else
                    (lambda r, lib=lib: baseline_coherent(lib, r,
                                                          keys_table)))
            elif name in ("kept", "per_lane") or name.startswith(kind):
                designs[name] = (
                    (lambda r, lib=lib: exact(lib, r)) if kind == "exact"
                    else (lambda r, lib=lib: coherent(lib, r)))
        if kind == "coherent" and "baseline" in libs:
            base = libs["baseline"]
            designs["prepass"] = lambda r: (
                coherent(libs["keys_only"], r, keys[r is None]),
                baseline_coherent(base, r, keys[r is None]))
        ref[kind] = outputs(designs["kept"])
        # every design once per round, rounds in turn: no design is
        # favoured by the card's clock ramp or the host's load
        times = {name: [] for name in designs}
        for _ in range(args.rounds):
            for name, fn in designs.items():
                ms = pair_ms(fn)
                if name == "baseline_table":
                    ms += 2 * cs.cuda_ms(table, args.reps)
                times[name].append(ms)
        for name, fn in designs.items():
            same = all(torch.equal(a, b)
                       for a, b in zip(outputs(fn), ref[kind]))
            ms = times[name]
            results[f"{kind}/{name}"] = dict(
                ms_min=min(ms), ms_median=float(np.median(ms)), ms=ms,
                bit_equal_to_kept=same)
            print(f"{kind} {name}: SSAO + SSR min {min(ms):.3f} ms, median "
                  f"{np.median(ms):.3f} ms over {len(ms)} rounds; occ and "
                  f"dif bit-equal to the kept kernel's: {same}", flush=True)
        if kind == "coherent" and "baseline" in libs:
            tms = 2 * cs.cuda_ms(table, args.reps)
            results["coherent/baseline_table"]["table_ms"] = tms
            print(f"coherent baseline_table: of which the two torch tables "
                  f"{tms:.3f} ms", flush=True)
    # the kept kernel's keys against the plain table on the card
    k = torch.full_like(keys_table, -1)
    coherent(libs["kept"], None, k)
    results["keys_bit_equal_to_plain_table"] = bool(torch.equal(k, keys_table))
    print(f"kept coherent keys bit-equal to centre_offset_table: "
          f"{results['keys_bit_equal_to_plain_table']}", flush=True)
    # lane efficiency of the lock-step walk (the counting build)
    lib = libs["count_lockstep"]
    for kind, fn, entry in (("exact", exact, "gigs_gi_march_count"),
                            ("coherent", coherent,
                             "gigs_gi_march_coherent_count")):
        counts = (ctypes.c_ulonglong * 2)()
        getattr(lib, entry)(ctypes.cast(counts, _P))     # reset
        for r in (None, rgb):
            fn(lib, r)
        torch.cuda.synchronize()
        getattr(lib, entry)(ctypes.cast(counts, _P))
        live, issued = counts[0], counts[1]
        results[f"{kind}/lanes_lockstep"] = dict(
            live_samples=live, issued_lane_steps=issued,
            efficiency=live / max(issued, 1))
        print(f"{kind} lock-step: {live} live samples, {issued} issued "
              f"lane-steps, efficiency {live / max(issued, 1):.4f}",
              flush=True)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(cs.card_line(), flush=True)
    print(f"SM clock, max SM clock: {clocks.strip()}", flush=True)
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
