"""The cell bicycle.train_p2 at the tiny size (perfbench/tests/tiny_sizes/
mip360_bicycle.json): each fault a training cell can have, planted under
the timed path, turns `correct` false, and the control (the reference on
bfloat16 inputs) reads outside the cell's limits where the program reads
inside them. The SH layer's readers: `sh_roofline.train` counts the least
bytes of the SH colour's forward and backward over the device time of
the operations under the spans sh and sh_bwd."""
from __future__ import annotations

import time
import types

import pytest
import torch

from perfbench import cells, control, faults, runner, spans, work
from perfbench.sides import PROGRAM
from gi_gs_tpu_torch.utils.timing import Span

from tiny import tiny_cell

CELL = "bicycle.train_p2"
SEED = 2 ** 31 + 29


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_planted_fault_is_not_correct(fault):
    assert fault in faults.FAULTS[tiny_cell(CELL).traffic["kind"]]
    with faults.planted(fault, PROGRAM):
        out = runner.run_cell(tiny_cell(CELL), SEED, 0.5, False,
                              torch.device("cpu"), time.time())
    assert not out["correct"], out["checks"]


def test_control_fails_and_program_passes():
    cell = tiny_cell(CELL)
    got = control.readings(cell, 2 ** 31 + 3, torch.device("cpu"),
                           ["program", "control"])
    lim = cell.limits
    assert all(v <= lim[k] for k, v in got["program"].items()), got
    assert any(v > lim[k] for k, v in got["control"].items()), got


def _sh_trace(n_gaussians, deg, ops):
    """A traced step whose forward opens sh under activations and whose
    backward's worker thread (2) opens sh_bwd under backward."""
    s = [Span("step", 1, 0, 1, 1, 0, 10_000),
         Span("activations", 2, 1, 1, 1, 100, 1_000),
         Span("sh", 3, 2, 1, 1, 200, 600),
         Span("backward", 4, 1, 1, 1, 2_000, 9_000),
         Span("sh_bwd", 5, 4, 1, 2, 3_000, 4_000)]
    d = spans.SpanData(steps=1, step_s=1e-5, host=s, counters={}, spans=s,
                       ops=ops, calls=[o.launch_ns for o in ops])
    x = types.SimpleNamespace(cell=types.SimpleNamespace(
        config={"n_gaussians": n_gaussians}), sh=(deg, 3))
    return types.SimpleNamespace(spans=d, inputs=x)


def test_sh_readers_count_the_least_bytes():
    roof = cells.metric_module("sh_roofline.train")
    # bicycle: 6.1 M live Gaussians at degree 3, 36 x 16 + 60 B each
    assert roof.nbytes(6_100_000, 3) == 6_100_000 * 636
    assert roof.nbytes(6_100_000, 3) / work.HBM_BYTES_PER_S * 1e3 == \
        pytest.approx(1.158, rel=1e-3)
    assert roof.nbytes(10, 0) == 10 * 96
    # 300 ns under sh (thread 1), 700 under sh_bwd (thread 2, launched
    # from autograd's worker), 400 elsewhere in the backward
    ops = [spans.Op("fwd", 300, 600, 250, 1),
           spans.Op("bwd", 3_100, 3_800, 3_050, 2),
           spans.Op("other", 5_000, 5_400, 4_900, 1)]
    t = _sh_trace(1000, 2, ops)
    dev_ms = cells.metric_reader("sh_device_ms.train")(t)
    assert dev_ms == pytest.approx(1e-3)
    assert roof.read(t) == pytest.approx(
        100 * roof.nbytes(1000, 2) / work.HBM_BYTES_PER_S / 1e-6)
    # nothing without inputs, spans, or device time under them
    assert roof.read(types.SimpleNamespace(spans=t.spans)) is None
    assert roof.read(types.SimpleNamespace(inputs=t.inputs)) is None
    assert roof.read(_sh_trace(1000, 2, ops[2:])) is None
    # a program with span mode but without the two spans reads nothing
    older = _sh_trace(1000, 2, ops)
    older.spans = spans.SpanData(
        steps=1, step_s=1e-5, host=[], counters={},
        spans=[s for s in older.spans.spans if not s.name.startswith("sh")],
        ops=ops, calls=[o.launch_ns for o in ops])
    assert cells.metric_reader("sh_device_ms.train")(older) is None
    assert roof.read(older) is None
