"""A run as the command line starts it, and its last line: with no card
it exits with an error and prints no result; on the CPU at a tiny size
(the harness's look for a card skipped) its line carries exactly the
result's keys, it is correct, and each fault that a cell can have,
planted under the timed path, turns `correct` false."""
from __future__ import annotations

import os
import subprocess
import sys
import time

import pytest
import torch

from perfbench import cells, faults, runner
from perfbench.sides import PROGRAM

from tiny import tiny_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
SEED = 2 ** 31 + 11
CELLS = [w["name"] for w in cells.benchmark()["workloads"]]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def _run(name: str, traced: bool = False, **traffic):
    return runner.run_cell(tiny_cell(name, **traffic), SEED, 0.5, traced,
                           torch.device("cpu"), time.time())


@pytest.mark.parametrize("name", CELLS + ["lego800.train_p1"])
def test_line_keys_and_a_sound_run(name):
    out = _run(name)
    assert list(out) == KEYS + ["checks"]
    assert out["correct"] and out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in
                                   tiny_cell(name).end_to_end}
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


@pytest.mark.parametrize("name,span", [
    ("garden.train_p1", "raster_ms.train"),
    ("lego800.serve_pbr", "screen_space_ms.serve"),
    ("lego800.train_p2", "light_ms.train")])
def test_traced_line_keys(name, span):
    out = _run(name, traced=True)
    assert list(out) == KEYS + ["breakdown", "checks"]
    assert out["correct"], out["checks"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert span in out["metrics"]
    assert set(out["metrics"]) <= {m["name"] for m in
                                   tiny_cell(name).per_layer}


@pytest.mark.parametrize("name,fault", [
    ("garden.train_p1", "unchanged"), ("garden.train_p1", "half_batch"),
    ("lego800.train_p1", "unchanged"), ("lego800.train_p1", "half_batch"),
    ("lego800.serve_pbr", "answer")])
def test_a_planted_fault_is_not_correct(name, fault):
    assert fault in faults.FAULTS[tiny_cell(name).traffic["kind"]]
    with faults.planted(fault, PROGRAM):
        out = _run(name)
    assert not out["correct"], out["checks"]
