"""One run of one cell: set-up, the measured window (or, with
`--trace 1`, the traced windows), then the check against the plain
reference. Returns the result line and the numbers compared."""
from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from . import compare, loops, trace, work
from .cells import Cell, metric_reader
from .sides import PROGRAM, REFERENCE, Side

# view indices drawn for a window: more steps than any window can take
MAX_WINDOW_STEPS = 200_000


def _free(dev) -> None:
    gc.unfreeze()
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def _quiet_gc() -> None:
    """Collect, then move every object set-up made out of the collector's
    reach, so that a collection inside the window walks only what the
    window itself allocates, not the harness's set-up."""
    gc.collect()
    gc.freeze()


def _pace(stamps: List[float]) -> None:
    """On stderr: the window's steady state, as milliseconds per step (or
    view) in each fifth of the window, from the host's issue (or
    completion) times."""
    n = len(stamps) - 1
    cuts = [stamps[round(n * k / 5)] for k in range(6)]
    per = [(b - a) * 1e3 / max(n / 5, 1) for a, b in zip(cuts, cuts[1:])]
    print(f"ms per step by fifth of the window: "
          f"{[round(float(x), 2) for x in per]}", file=sys.stderr)


def _device(dev, chips: int) -> Dict:
    if torch.device(dev).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def _metric(cell: Cell, name: str, value: float) -> Dict:
    unit = {m["name"]: m["unit"]
            for m in cell.end_to_end + cell.per_layer}[name]
    return {"value": value, "unit": unit}


def _per_layer(cell: Cell, data: "trace.TraceData") -> Dict:
    out = {}
    for m in cell.per_layer:
        v = metric_reader(m["name"])(data)
        if v is not None:
            out[m["name"]] = _metric(cell, m["name"], v)
    return out


# ---------------------------------------------------------------------------
# Training cells
# ---------------------------------------------------------------------------

def run_train(cell: Cell, seed: int, seconds: float, traced: bool, dev,
              started: float) -> Dict:
    tr = cell.traffic
    k, warm = tr["check_steps"], tr["warmup_steps"]
    marks: Dict[str, float] = {"_t": time.perf_counter(),
                               "process": time.time() - started}
    run = loops.train_setup(Side(PROGRAM), cell, seed, dev, marks=marks)
    order = loops.view_order(len(run.cams), k + warm + MAX_WINDOW_STEPS,
                               seed)
    prog = loops.checked_steps(run, order, k)
    loops._mark(marks, "checked_steps", dev)
    loops.train_steps(run, order, k, warm)
    loops._mark(marks, "warmup", dev)
    setup_s = time.time() - started
    first = k + warm
    res: Dict = {}
    if traced:
        data, got = trace.windows(
            lambda i0, n: loops.train_steps(run, order, first + i0, n),
            tr["trace_steps"], Side(PROGRAM).timing, dev,
            lambda i0: work.inputs(cell, run.state.params,
                                   run.cams[order[first + i0]], run.cfg))
        aux = [a for part in got for a in part]
        res["metrics"] = _per_layer(cell, data)
        res["breakdown"] = data.breakdown()
        res["trace_device"] = {"busy_s": data.busy_s,
                               "window_s": data.window_s}
        del data
    else:
        aux: List = []
        _quiet_gc()
        t0 = time.perf_counter()
        i = first
        stamps = [t0]
        while stamps[-1] - t0 < seconds:
            aux += loops.train_steps(run, order, i, 1)
            i += 1
            stamps.append(time.perf_counter())
        loops.sync(dev)
        window = time.perf_counter() - t0
        _pace(stamps)
        res["metrics"] = {
            "train_step_ms": _metric(cell, "train_step_ms",
                                     window / len(aux) * 1e3),
            "setup_s": _metric(cell, "setup_s", setup_s)}
    res["device"] = _device(dev, cell.chips)
    attempted = len(aux)
    losses = [float(a.loss) for a in aux]
    overflow = max([prog["overflow"]] + [int(a.overflow) for a in aux])
    del run, aux
    _free(dev)
    ref_run = loops.train_setup(Side(REFERENCE), cell, seed, dev)
    ref = loops.checked_steps(ref_run, order, k)
    del ref_run
    _free(dev)
    gaps = compare.train_gaps(prog, ref)
    gaps["overflow"] = float(overflow)
    res["attempted"] = attempted
    res["setup_parts"] = marks
    res["failed"] = sum(not math.isfinite(x) for x in losses)
    res["checks"] = compare.checks(gaps, cell.limits)
    return res


# ---------------------------------------------------------------------------
# Serving cells
# ---------------------------------------------------------------------------

def run_serve(cell: Cell, seed: int, seconds: float, traced: bool, dev,
              started: float) -> Dict:
    tr = cell.traffic
    marks: Dict[str, float] = {"_t": time.perf_counter(),
                               "process": time.time() - started}
    run = loops.serve_setup(Side(PROGRAM), cell, seed, dev, marks=marks)
    order = loops.view_order(len(run.cams), tr["warmup_views"]
                               + MAX_WINDOW_STEPS, seed)
    for v in order[:tr["warmup_views"]]:
        loops.serve_view(run, v)
    loops._mark(marks, "warmup", dev)
    order = order[tr["warmup_views"]:]
    setup_s = time.time() - started
    res: Dict = {}
    if traced:
        n = tr["trace_views"]
        data, got = trace.windows(
            lambda i0, m: [loops.serve_at(run, order, i)
                           for i in range(i0, i0 + m)],
            n, Side(PROGRAM).timing, dev,
            lambda i0: work.inputs(cell, run.state.params,
                                   run.cams[order[i0]], run.cfg))
        views = [v for part in got for v in part]
        overflow = max(int(o) for _, o in views)
        kept = {i: views[i][0] for i in range(min(tr["check_views"],
                                                  len(views)))}
        attempted = len(views)
        res["metrics"] = _per_layer(cell, data)
        res["breakdown"] = data.breakdown()
        res["trace_device"] = {"busy_s": data.busy_s,
                               "window_s": data.window_s}
        del data, views, got
    else:
        keep = set(loops.sample_positions(seed, tr["check_views"],
                                            tr["check_within"]))
        _quiet_gc()
        w = loops.serve_window(run, order, seconds, keep)
        _pace([0.0] + w["done"])
        attempted = len(w["latency"])
        overflow = int(torch.stack(w["overflow"]).max())
        kept = w["kept"]
        res["metrics"] = {
            "view_ms": _metric(cell, "view_ms",
                               w["window"] / attempted * 1e3),
            "view_p95_ms": _metric(cell, "view_p95_ms",
                                   p95(w["latency"]) * 1e3),
            "setup_s": _metric(cell, "setup_s", setup_s)}
        del w
    res["device"] = _device(dev, cell.chips)
    del run
    _free(dev)
    ref_run = loops.serve_setup(Side(REFERENCE), cell, seed, dev)
    ref = {i: loops.serve_at(ref_run, order, i)[0] for i in sorted(kept)}
    del ref_run
    _free(dev)
    gaps = compare.view_gaps(kept, ref)
    gaps["overflow"] = float(overflow)
    res["attempted"] = attempted
    res["setup_parts"] = marks
    res["failed"] = gaps.pop("views_failed")
    res["checks"] = compare.checks(gaps, cell.limits)
    return res


def p95(values: List[float]) -> float:
    """The 95th percentile by nearest rank: the smallest value that at
    least 95% of the values do not exceed."""
    v = sorted(values)
    return v[max(math.ceil(0.95 * len(v)) - 1, 0)]


# the system's two entry points, which a mix's `kind` names
LOOPS = {"train": run_train, "serve": run_serve}


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, dev,
             started: float) -> Dict:
    """The result line's fields (and `checks`) of one run."""
    if torch.device(dev).type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    res = LOOPS[cell.traffic["kind"]](cell, seed, seconds, traced, dev,
                                        started)
    dev_info = res.pop("device")
    dev_info.update(res.pop("trace_device", {}))
    checks = res.pop("checks")
    parts = {k: round(v, 3) for k, v in res.pop("setup_parts").items()
             if not k.startswith("_")}
    print(f"set-up seconds by part: {parts}", file=sys.stderr)
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": res.pop("attempted"), "failed": res.pop("failed"),
           "metrics": res.pop("metrics"), "device": dev_info}
    if "breakdown" in res:
        out["breakdown"] = res.pop("breakdown")
    out["checks"] = checks
    return out
