"""A cell of BENCHMARK.json and the files it is made of, found by name:
its configuration (`configs/<name>.json`), its traffic mix
(`traffic/<name>.json`, the parameters of loops.py's generator), its
limits (`limits/<cell>.json`) and the readers of its per-layer metrics
(`metrics/<metric>.py`)."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]        # the e2e metric entries this cell reports
    per_layer: List[dict]         # the per-layer metric entries it reports


def benchmark(kept_out: bool = False) -> dict:
    """BENCHMARK.json; with `kept_out`, the cells of `kept_out.json` laid
    over it (their entries and their metrics' lists of cells)."""
    bench = _load_json(os.path.join(ROOT, "BENCHMARK.json"))
    if kept_out:
        ko = _load_json(os.path.join(HERE, "kept_out.json"))
        bench["workloads"] += ko["workloads"]
        bench["per_layer"] += ko["per_layer"]
        for group, extra in (("end_to_end", ko["end_to_end_workloads"]),
                             ("per_layer", ko["per_layer_workloads"])):
            for m in bench[group]:
                if m["name"] in extra:
                    m["workloads"] = m["workloads"] + extra[m["name"]]
    return bench


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    cfg = _load_json(os.path.join(ROOT, config["file"]))
    traffic = _load_json(os.path.join(HERE, "traffic",
                                      entry["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, chips=entry["chips"], config=cfg, traffic=traffic,
                limits=_load_json(os.path.join(HERE, "limits",
                                               name + ".json")),
                end_to_end=e2e, per_layer=layer)


def metric_module(name: str):
    """The module `metrics/<name>.py`."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> Callable:
    """`read(trace) -> float | None` of `metrics/<name>.py`."""
    return metric_module(name).read
