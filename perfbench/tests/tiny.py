"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds: the
same files, the same code, fewer Gaussians, pixels, views and texels.

A configuration's CPU size is data of its own, `tiny_sizes/<name>.json`,
laid over its configuration file: a new configuration brings its size as
a new file, and no file here changes."""
from __future__ import annotations

import copy
import json
import os

from perfbench import cells

SIZES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "tiny_sizes")
TRAFFIC = dict(check_views=2, check_within=4, trace_views=2, trace_steps=2,
               warmup_views=1, warmup_steps=1)


def _merge(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _merge(dst.setdefault(k, {}), v)
        else:
            dst[k] = v


def sizes(config: str) -> dict:
    """The CPU size of the configuration `config`, from
    `tiny_sizes/<config>.json`."""
    path = os.path.join(SIZES, config + ".json")
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise FileNotFoundError(
            f"no CPU size for the configuration {config!r}: add "
            f"{os.path.relpath(path, cells.ROOT)}, the keys of its "
            "configuration file to lay over it for the CPU tests") from None


def tiny_cell(name: str, **traffic) -> cells.Cell:
    """The cell `name` (of BENCHMARK.json or kept_out.json) at the tiny
    size, its mix's keys overridden by `traffic`."""
    cell = cells.load_cell(name, cells.benchmark(kept_out=True))
    cfg = copy.deepcopy(cell.config)
    _merge(cfg, sizes(cfg["name"]))
    tr = {**cell.traffic, **{k: v for k, v in TRAFFIC.items()
                             if k in cell.traffic}, **traffic}
    return cells.Cell(cell.name, cell.chips, cfg, tr, dict(cell.limits),
                      cell.end_to_end, cell.per_layer)
