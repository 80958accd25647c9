"""The control, the reference put in the program's place with its inputs
in bfloat16, comes out as not correct against the cell's limits, at a
size the CPU holds; the program itself reads within them. On the card,
`perfbench/control.py` takes the same readings at the cell's own size."""
from __future__ import annotations

import pytest
import torch

from perfbench import control

from tiny import tiny_cell


@pytest.mark.parametrize("name", ["garden.train_p1", "lego800.train_p1",
                                  "lego800.serve_pbr"])
def test_control_fails_and_program_passes(name):
    cell = tiny_cell(name)
    got = control.readings(cell, 2 ** 31 + 3, torch.device("cpu"),
                           ["program", "control"])
    lim = cell.limits
    assert all(v <= lim[k] for k, v in got["program"].items()), got
    assert any(v > lim[k] for k, v in got["control"].items()), got
