"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds: the
same files, the same code, fewer Gaussians, pixels, views and texels."""
from __future__ import annotations

import copy

from perfbench import cells

SHRINK = {
    "tensoir_lego_800": dict(
        n_gaussians=2000, capacity=4096,
        cameras=dict(width=64, height=48, n_train=4, n_test=4),
        port=dict(train=dict(light_base_res=16),
                  gi=dict(delta=0.25, step=4, start=2))),
    "mip360_garden": dict(
        n_gaussians=3000, capacity=4096,
        cameras=dict(width=64, height=48, n_views=9),
        port=dict(train=dict(light_base_res=16),
                  gi=dict(delta=0.25, step=4, start=2))),
}
TRAFFIC = dict(check_views=2, check_within=4, trace_views=2, trace_steps=2,
               warmup_views=1, warmup_steps=1)


def _merge(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _merge(dst.setdefault(k, {}), v)
        else:
            dst[k] = v


def tiny_cell(name: str, **traffic) -> cells.Cell:
    """The cell `name` (of BENCHMARK.json or kept_out.json) at the tiny
    size, its mix's keys overridden by `traffic`."""
    cell = cells.load_cell(name, cells.benchmark(kept_out=True))
    cfg = copy.deepcopy(cell.config)
    _merge(cfg, SHRINK[cfg["name"]])
    tr = {**cell.traffic, **{k: v for k, v in TRAFFIC.items()
                             if k in cell.traffic}, **traffic}
    return cells.Cell(cell.name, cell.chips, cfg, tr, dict(cell.limits),
                      cell.end_to_end, cell.per_layer)
