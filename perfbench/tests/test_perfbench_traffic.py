"""The generator's knobs, each a key of a mix's data file, at a tiny
size on the CPU: views arriving at a fixed rate (an open loop), the
light rebuilt every k views, and capacities sized with headroom. Each
run is checked against the plain reference as a cell's run is."""
from __future__ import annotations

import time

import torch

from perfbench import loops, runner
from perfbench.sides import PROGRAM, Side

from tiny import tiny_cell

SEED = 2 ** 31 + 29
CPU = torch.device("cpu")


def _run(cell, seconds=0.5):
    return runner.run_cell(cell, SEED, seconds, False, CPU, time.time())


def test_open_loop_paces_arrivals():
    cell = tiny_cell("lego800.serve_pbr", arrival_fps=4.0)
    out = _run(cell, seconds=1.0)
    assert out["correct"], out["checks"]
    # arrivals at 0, 0.25, 0.5 and 0.75 s: at most four views, and the
    # window lasts past the last one's arrival
    n = out["attempted"]
    assert 1 <= n <= 4
    assert out["metrics"]["view_ms"]["value"] * n >= 250.0 * (n - 1)


def test_relighting_every_k_views():
    cell = tiny_cell("lego800.serve_pbr", relight_every=2)
    run = loops.serve_setup(Side(PROGRAM), cell, SEED, CPU)
    first = run.state.cubemap
    order = loops.view_order(len(run.cams), 5, SEED)
    for i in range(5):
        loops.serve_at(run, order, i)
    assert run.light_index == 2
    assert not torch.equal(run.state.cubemap, first)
    out = _run(tiny_cell("lego800.serve_pbr", relight_every=1,
                         check_within=3, check_views=2))
    assert out["correct"], out["checks"]


def test_instance_headroom_scales_capacities():
    side = Side(PROGRAM)
    base = loops.train_setup(side, tiny_cell("garden.train_p1"), SEED, CPU)
    more = loops.train_setup(side, tiny_cell("garden.train_p1",
                                             instance_headroom=2.0),
                             SEED, CPU)
    assert more.cfg.raster.cap_instances >= \
        2 * base.cfg.raster.cap_instances - side.binning_quantum
    assert more.cfg.raster.cap_tile >= base.cfg.raster.cap_tile
    out = _run(tiny_cell("garden.train_p1", instance_headroom=2.0))
    assert out["correct"], out["checks"]
