"""Metric aggregation CLI (the port's own copy of
gi_gs_tpu/cli/collect_cli.py; a generic replacement for the reference's
six `collect_{metrics,nvs,relight}[_v5].py` scripts, which differ only in
hard-coded dataset/envmap name lists and base paths): globs metric JSON
files under a base path, aggregates mean/std per numeric key, prints and
saves the summary.

    python -m gi_gs_tpu_torch.cli.collect_cli --base OUT \
        [--pattern '**/*.json'] [--keys psnr_avg ...] [--out summary.json]
"""
from __future__ import annotations

import glob
import json
import math
import os
from argparse import ArgumentParser
from collections import defaultdict


def mean_std(values):
    if not values:
        return 0.0, 0.0
    m = sum(values) / len(values)
    s = math.sqrt(sum((x - m) ** 2 for x in values) / len(values))
    return m, s


def main(argv=None):
    parser = ArgumentParser(description="aggregate metric JSONs")
    parser.add_argument("--base", type=str, required=True,
                        help="base directory to search")
    parser.add_argument("--pattern", type=str, default="**/*.json",
                        help="glob under base (e.g. '**/pbr/*NVS*.json')")
    parser.add_argument("--keys", nargs="+", default=None,
                        help="restrict to these metric keys")
    parser.add_argument("--out", type=str, default="")
    args = parser.parse_args(argv)

    acc = defaultdict(list)
    files = sorted(glob.glob(os.path.join(args.base, args.pattern),
                             recursive=True))
    for path in files:
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError) as e:   # unreadable or not JSON
            print(f"skip {path}: {e}")
            continue
        if not isinstance(data, dict):
            continue
        for k, v in data.items():
            if isinstance(v, (int, float)) and \
                    (args.keys is None or k in args.keys):
                acc[k].append(float(v))

    summary = {}
    for k, vals in sorted(acc.items()):
        m, s = mean_std(vals)
        summary[k] = {"mean": m, "std": s, "n": len(vals)}
        print(f"{k}: mean {m:.4f} std {s:.4f} (n={len(vals)})")
    print(f"({len(files)} files scanned)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
