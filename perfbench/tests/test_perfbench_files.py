"""BENCHMARK.json and the files it names: every configuration, traffic
mix, limit file and per-layer metric loads by its name, and every name
and unit keeps to the characters the benchmark allows."""
from __future__ import annotations

import json
import os
import re

import pytest

from perfbench import cells

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
E2E = {m["name"] for m in BENCH["end_to_end"]}


def test_top_level_keys_and_paths():
    assert set(BENCH) == TOP_KEYS
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(BENCH["command"]) <= 32
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(cells.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            yield group, e


@pytest.mark.parametrize("group,entry", list(_names()),
                         ids=lambda x: x if isinstance(x, str) else x["name"])
def test_names_units_and_lines(group, entry):
    assert NAME.match(entry["name"])
    for k in ("config", "traffic"):
        if k in entry:
            assert NAME.match(entry[k])
    for k in entry.get("reduced", []):
        assert NAME.match(k)
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for k in ("why", "layer", "source"):
        if k in entry and group != "end_to_end" and group != "per_layer":
            assert 1 <= len(entry[k]) <= 200 and "\n" not in entry[k]
    if group == "end_to_end":
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    if group == "per_layer":
        assert entry["moves"] in E2E
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(name):
    cell = cells.load_cell(name)
    assert cell.traffic["kind"] in ("train", "serve")
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    assert cell.limits and all(v >= 0 for v in cell.limits.values())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_loads_by_name(metric):
    assert callable(cells.metric_reader(metric))


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=lambda c: c["name"])
def test_config_file_names_its_cuts(config):
    with open(os.path.join(cells.ROOT, config["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == config["name"]
    assert cfg["reduced"] == config["reduced"]
    assert isinstance(cfg["assumed"], dict) and cfg["assumed"]
    assert config["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
