"""Readings that the limits of `limits/<cell>.json` are set from, at the
cell's own size, with no measured window:

- `program`: the program's checked steps (or views) against the plain
  reference: the lower readings, sound runs;
- `control`: the reference in the program's place with every input
  rounded to bfloat16, the precision below the f32 the configuration
  states: it must come out as not correct;
- the faults of `faults.py` that the cell can have, planted in the
  program.

    python3 perfbench/control.py --workload <cell> --seeds 11 12 13 \
        [--variants program control half_batch]

prints one JSON line per seed and variant: the numbers compared, as the
benchmark's check computes them. The reference's tables are built once
per process and serve every seed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

from perfbench import cells, compare, faults, loops  # noqa: E402
from perfbench.sides import PROGRAM, REFERENCE, Side  # noqa: E402


def _train_record(cell, seed, dev, package, control=False):
    run = loops.train_setup(Side(package), cell, seed, dev, control)
    order = loops.view_order(len(run.cams), cell.traffic["check_steps"],
                               seed)
    rec = loops.checked_steps(run, order, cell.traffic["check_steps"])
    del run
    return rec


def _serve_record(cell, seed, dev, package, control=False):
    run = loops.serve_setup(Side(package), cell, seed, dev, control)
    tr = cell.traffic
    order = loops.view_order(len(run.cams), tr["warmup_views"]
                               + tr["check_within"], seed)
    order = order[tr["warmup_views"]:]
    pos = loops.sample_positions(seed, tr["check_views"],
                                   tr["check_within"])
    rec = {i: loops.serve_at(run, order, i)[0] for i in pos}
    del run
    return rec


# per entry point a mix can drive: its record and its comparison
KINDS = {"train": (_train_record, compare.train_gaps),
         "serve": (_serve_record, compare.view_gaps)}


def readings(cell, seed: int, dev, variants) -> dict:
    """{variant: the compared numbers} of one seed."""
    record, gaps = KINDS[cell.traffic["kind"]]
    ref = record(cell, seed, dev, REFERENCE)
    out = {}
    for v in variants:
        if v == "program":
            got = record(cell, seed, dev, PROGRAM)
        elif v == "control":
            got = record(cell, seed, dev, REFERENCE, control=True)
        else:
            with faults.planted(v, PROGRAM):
                got = record(cell, seed, dev, PROGRAM)
        g = gaps(got, ref)
        g.pop("views_failed", None)
        g.pop("overflow", None)
        out[v] = g
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = cells.load_cell(args.workload, cells.benchmark(kept_out=True))
    variants = args.variants or (
        ["program", "control"] + list(faults.FAULTS[cell.traffic["kind"]]))
    dev = torch.device(args.device)
    for seed in args.seeds:
        for v, g in readings(cell, seed, dev, variants).items():
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "variant": v, **g}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
