"""A configuration is an addition of files and entries. In a copy of the
benchmark's files, a configuration is added under a new name (the
garden's sizes): its configuration file, its CPU size
(`tests/tiny_sizes/<name>.json`), its cell's limits, and entries in
BENCHMARK.json. Its cell then runs at the tiny size and is correct, and
no file that was there changed but BENCHMARK.json. Without its CPU size
the run stops with an error that names the file to add."""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BASE, BASE_CELL = "mip360_garden", "garden.train_p1"
NEW, NEW_CELL = "mip360_garden_copy", "garden_copy.train_p1"
SEED = 2 ** 31 + 37
RUN = """
import json, sys, time
import torch
from tiny import tiny_cell
from perfbench import runner
out = runner.run_cell(tiny_cell(sys.argv[1]), int(sys.argv[2]), 0.5, False,
                      torch.device("cpu"), time.time())
print(json.dumps(out))
"""


def _hashes(root):
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return out


def _load(path):
    with open(path) as f:
        return json.load(f)


def _dump(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def _add_config(copy, with_sizes):
    """NEW and its cell NEW_CELL, as a later PR would add them: new files,
    and new entries (and the new cell in the metrics' lists of cells)."""
    pb = os.path.join(copy, "perfbench")
    cfg = _load(os.path.join(pb, "configs", BASE + ".json"))
    cfg["name"] = NEW
    _dump(cfg, os.path.join(pb, "configs", NEW + ".json"))
    shutil.copy(os.path.join(pb, "limits", BASE_CELL + ".json"),
                os.path.join(pb, "limits", NEW_CELL + ".json"))
    if with_sizes:
        shutil.copy(os.path.join(pb, "tests", "tiny_sizes", BASE + ".json"),
                    os.path.join(pb, "tests", "tiny_sizes", NEW + ".json"))
    bench = _load(os.path.join(copy, "BENCHMARK.json"))
    base = {c["name"]: c for c in bench["configs"]}[BASE]
    bench["configs"].append(dict(base, name=NEW,
                                 file=f"perfbench/configs/{NEW}.json"))
    cell = {w["name"]: w for w in bench["workloads"]}[BASE_CELL]
    bench["workloads"].append(dict(cell, name=NEW_CELL, config=NEW))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if BASE_CELL in m.get("workloads", []):
            m["workloads"].append(NEW_CELL)
    _dump(bench, os.path.join(copy, "BENCHMARK.json"))


@pytest.mark.parametrize("with_sizes", [True, False],
                         ids=["files_only", "no_cpu_size"])
def test_a_configuration_is_files_and_entries(tmp_path, with_sizes):
    copy = str(tmp_path / "checkout")
    shutil.copytree(os.path.join(ROOT, "perfbench"),
                    os.path.join(copy, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy)
    before = _hashes(copy)
    _add_config(copy, with_sizes)
    after = _hashes(copy)
    changed = {p for p in before if after[p] != before[p]}
    assert changed == {"BENCHMARK.json"}
    # the copy's harness, the tiny sizes beside it, the program from here
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [copy, os.path.join(copy, "perfbench", "tests"), ROOT]))
    out = subprocess.run([sys.executable, "-c", RUN, NEW_CELL, str(SEED)],
                         cwd=copy, env=env, capture_output=True, text=True,
                         timeout=600)
    if not with_sizes:
        assert out.returncode != 0
        assert f"perfbench/tests/tiny_sizes/{NEW}.json" in out.stderr
        return
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"train_step_ms", "setup_s"}
