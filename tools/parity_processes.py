#!/usr/bin/env python3
"""Run the scene of chip_smoke.py's phase 6 (render parity) in fresh
processes on one NVIDIA GPU, to tell a per-process fault from a per-call one.

    python3 tools/parity_processes.py [--processes 12] [--parallel 4]
                                      [--repeats 2] [--checkout DIR]

Each process is a new interpreter (a new CUDA context and address space).
It builds the scene of `chip_smoke.parity_phase` (seed 1: 3000 Gaussians,
a 64x48 view, the exact march) and renders it with `render_pbr_view` once
on the CPU and `--repeats` times on the card. It checks that the card's
repeats are bit-equal and holds the card's first render to phase 6's
tolerance against the CPU's: the GI-fed keys may differ by more than 1e-4
on under 1% of pixels and by at most 0.02, every other key by at most
1e-4. It prints one line per process: the verdict, an md5 of all CPU and
of all card outputs, and the keys out of tolerance with their share of
pixels and largest difference; then the count of each distinct line.
`--checkout DIR` runs another checkout's package and chip_smoke.py (for
example the parent commit, unpacked with `git archive`). Needs a card.
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


def worker(repeats: int) -> None:
    import types

    import numpy as np
    import torch
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from gi_gs_tpu_torch import config as config_mod
    from gi_gs_tpu_torch.cli import render_cli
    from gi_gs_tpu_torch.models.gaussians import params_from_numpy
    from gi_gs_tpu_torch.scene.cameras import make_camera

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

    def render(device):
        state = types.SimpleNamespace(
            params=params_from_numpy(fields, 3, 3, device=device),
            cubemap=torch.as_tensor(cub, device=device))
        cam = make_camera(np.eye(3), np.array([0.0, 0.0, 3.0]), 0.9, 0.7,
                          64, 48, device=device)
        with torch.inference_mode():
            out = render_cli.render_pbr_view(cfg, state, cam,
                                             torch.zeros(3, device=device))
        return {k: v.detach().cpu().clone() for k, v in out.items()}

    def md5(out):
        return hashlib.md5(b"".join(out[k].numpy().tobytes()
                                    for k in sorted(out))).hexdigest()[:10]

    cpu = render(torch.device("cpu"))
    cuda = [render(torch.device("cuda")) for _ in range(repeats)]
    stable = all(md5(c) == md5(cuda[0]) for c in cuda[1:])
    bad = []
    for key, a in cuda[0].items():
        diff = (a.double() - cpu[key].double()).abs()
        share = float((diff > 1e-4).double().mean()) if diff.numel() else 0.0
        worst = float(diff.max()) if diff.numel() else 0.0
        ok = (share < 0.01 and worst < 0.02) if key in GI_KEYS \
            else worst <= 1e-4
        if not ok:
            bad.append(f"{key} {share:.4f} {worst:.7f}")
    print(f"RESULT {'ok' if not bad else 'FAIL'} cpu {md5(cpu)} cuda "
          f"{md5(cuda[0])} repeats {'bit-equal' if stable else 'DIFFER'}"
          + (" | " + "; ".join(bad) if bad else ""), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--processes", type=int, default=12)
    ap.add_argument("--parallel", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--checkout", default=REPO)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.repeats)
        return
    root = os.path.abspath(args.checkout)
    cmd = [sys.executable, os.path.abspath(__file__), "--worker",
           "--repeats", str(args.repeats)]
    lines = []
    for first in range(0, args.processes, args.parallel):
        procs = [subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for _ in range(min(args.parallel, args.processes - first))]
        for p in procs:
            out, _ = p.communicate(timeout=600)
            got = [ln for ln in out.splitlines() if ln.startswith("RESULT")]
            tail = " / ".join(out.strip().splitlines()[-2:])
            line = got[0] if got else f"RESULT ERROR {tail}"
            lines.append(line)
            print(line, flush=True)
    print(f"{root}: {len(lines)} processes")
    for line, count in collections.Counter(lines).most_common():
        print(f"  {count} x {line}")


if __name__ == "__main__":
    main()
