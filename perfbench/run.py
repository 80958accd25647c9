"""The benchmark of gi_gs_tpu_torch on NVIDIA GPUs: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (an entry of BENCHMARK.json's `workloads`) names a
configuration and a traffic mix. The run makes its inputs from the seed,
sets up and warms the program (counted in `setup_s`), measures for
`--seconds` (or, with `--trace 1`, runs the profiler's and the stage
timer's windows), checks what the timed path produced against the plain
reference, and prints one JSON line: `correct`, `attempted`, `failed`,
`metrics`, `device` (and with `--trace 1` `breakdown`), then `checks`,
each compared number beside its limit. It needs a card: without one it
exits with an error and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the program's kernel caches, at fixed paths inside the checkout
CACHES = {"TRITON_CACHE_DIR": os.path.join(ROOT, "build", "triton_cache"),
          "TORCH_EXTENSIONS_DIR": os.path.join(ROOT, "build",
                                               "torch_extensions")}
FORBIDDEN = ("jax", "jaxlib", "flax", "gi_gs_tpu")


def process_start() -> float:
    """Epoch seconds at which this process started (from /proc, to 10 ms),
    or now where /proc cannot tell."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def loaded_forbidden() -> list:
    """Modules of JAX or of the JAX package loaded in this process, by
    whole top-level name (gi_gs_tpu_torch is not gi_gs_tpu)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    started = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for k, v in CACHES.items():
        os.environ[k] = v
    sys.path.insert(0, ROOT)
    import torch
    from perfbench import cells, runner

    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ". No result.", file=sys.stderr)
        return 3
    out = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), started)
    bad = loaded_forbidden()
    if bad:
        print(f"perfbench: JAX or the JAX package was loaded: {bad}. "
              "No result.", file=sys.stderr)
        return 4
    for k, c in out["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
