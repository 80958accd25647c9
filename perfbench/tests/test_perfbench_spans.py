"""The span windows and the span metrics (perfbench/spans.py, the entries
of BENCHMARK.json whose metrics/<name>.py reads perfbench.spans): each
reader on a synthetic trace (attribution through the launch across
threads, unions of intervals, idle gaps by span, sync idle, host issue,
counters), nothing from a program without span mode, and on the CPU at a
tiny size a traced run of each cell, whose line carries the span metrics
of that cell, and whose four windows read as they do without the span
windows."""
from __future__ import annotations

import time
import types

import pytest
import torch

from perfbench import cells, runner, spans, trace, work
from gi_gs_tpu_torch.utils.timing import Span

from tiny import tiny_cell

SEED = 2 ** 31 + 23
METRICS = {m["name"]: m for m in cells.benchmark()["per_layer"]
           if getattr(cells.metric_module(m["name"]), "spans", None)
           is spans}
CELLS = sorted({c for m in METRICS.values() for c in m["workloads"]})


def synthetic(steps=1):
    """One step on the main thread (1) with a backward whose worker
    thread (2) opens composite_bwd; kineto names the launching thread
    99, which no span has, so launches fall back to any thread."""
    s = [Span("step", 1, 0, 1, 1, 0, 1000),
         Span("preprocess", 2, 1, 1, 1, 10, 100),
         Span("sync.x", 3, 1, 1, 1, 100, 200),
         Span("backward", 4, 1, 1, 1, 300, 900),
         Span("composite_bwd", 5, 4, 1, 2, 400, 600),
         Span("sync.y", 6, 1, 1, 1, 930, 940)]
    ops = [spans.Op("a", 50, 150, 20, 99),       # under preprocess
           spans.Op("b", 420, 700, 410, 99),     # composite_bwd (thread 2)
           spans.Op("c", 650, 800, 320, 1),      # backward, on thread 1
           spans.Op("d", 900, 950),              # no launch recorded
           spans.Op("e", 1200, 1300, 1100, 99)]  # launched outside
    calls = [o.launch_ns for o in ops if o.launch_ns is not None]
    return spans.SpanData(steps=steps, step_s=1e-6, host=s,
                          counters={"host_syncs": 2, "instances": 40},
                          spans=s, ops=ops, calls=calls)


def trace_of(data):
    return types.SimpleNamespace(spans=data)


def test_attribution_by_launch_across_threads():
    d = synthetic()
    got = {o.name: o.span.name if o.span else None for o in d.ops}
    assert got == {"a": "preprocess", "b": "composite_bwd",
                   "c": "backward", "d": None, "e": None}
    # on its own thread, a launch goes to that thread's innermost span
    # even where another thread opened a span later
    d.ops[1].thread = 1
    spans.attribute(d.ops, d.spans)
    assert d.ops[1].span.name == "backward"


def test_union_gaps_and_idle_by_span():
    assert spans.union_ns([(0, 10), (5, 20), (30, 40), (35, 36)]) == 30
    assert spans.union_ns([]) == 0
    d = synthetic()
    assert spans.gaps(d.ops) == [(150, 420), (800, 900), (950, 1200)]
    assert spans.idle_by_span(d) == pytest.approx(
        {"sync.x": 270e-6, "backward": 100e-6, "step": 250e-6})


def test_readers_on_a_synthetic_trace():
    t = trace_of(synthetic())
    read = lambda name: cells.metric_reader(name)(t)
    assert read("composite_bwd_device_ms.train") == pytest.approx(280e-6)
    assert spans.device_ms(t, "backward") == pytest.approx(380e-6)
    assert read("raster_device_ms.serve") == pytest.approx(100e-6)
    assert read("screen_space_device_ms.serve") == 0.0
    # gaps opening in sync.x, and after sync.y before the next launch
    assert read("sync_idle_ms.train") == pytest.approx(520e-6)
    assert read("host_issue_ms.train") == pytest.approx(890e-6)
    assert read("host_issue_ms.serve") is None          # no view span
    assert read("host_syncs_per_step.train") == 2
    assert read("instances_per_view.serve") == 40
    two = trace_of(synthetic(steps=2))
    assert cells.metric_reader("instances_per_view.serve")(two) == 20
    rep = spans.report(two.spans, 0.5e-6)
    assert rep["attributed_pct"] == pytest.approx(100 * 480 / 630)
    assert set(rep["unattributed_ms"]) == {"d", "e"}
    assert rep["syncs_per_step"] == {"sync.x": 0.5, "sync.y": 0.5}
    assert rep["tracing_cost_pct"] == pytest.approx(100.0)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_nothing_without_spans(name):
    read = cells.metric_reader(name)
    assert read(types.SimpleNamespace()) is None
    assert read(trace_of(None)) is None


def test_no_span_mode_no_windows():
    """The windows of a program without span mode (the timing module of
    an older program) are skipped, and run nothing."""
    ran = []
    data, got = spans.windows(lambda i0, n: ran.append(i0), 2,
                              types.SimpleNamespace(), "cpu", 8)
    assert (data, got, ran) == (None, [], [])


def test_entries_name_files_and_cells():
    bench = cells.benchmark()
    known = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert len(METRICS) >= 12
    for m in METRICS.values():
        assert m["source"] in ("program_span", "program_counter")
        assert set(m["workloads"]) <= known
        assert set(m["workloads"]) <= set(e2e[m["moves"]]["workloads"])
        assert callable(cells.metric_reader(m["name"]))


@pytest.mark.parametrize("name", CELLS)
def test_traced_line_with_span_windows(name):
    kept = []
    with spans.after_the_six(kept):
        out = runner.run_cell(tiny_cell(name), SEED, 0.5, True,
                              torch.device("cpu"), time.time())
    assert out["correct"], out["checks"]
    assert {m for m in METRICS if name in METRICS[m]["workloads"]} <= \
        set(out["metrics"])
    data, plain, pairs = kept[0]
    assert {s.name for s in data.spans if s.parent == 0} == \
        {"view" if "serve" in name else "step"}
    assert len(pairs) == 3 and all(p > 0 and a > 0 for p, a in pairs)
    rep = spans.report(data, plain, pairs)
    assert rep["counters_per_step"]["host_syncs"] >= 6
    assert rep["counters_per_step"]["instances"] > 0


def _traced(name, monkeypatch, span_windows):
    """A traced run of the cell at the tiny size, and its TraceData."""
    got = []
    six = trace.windows

    def keep(*args):
        data, res = six(*args)
        got.append(data)
        return data, res

    with monkeypatch.context() as m:
        m.setattr(trace, "windows", keep)
        if not span_windows:
            m.setattr(spans, "windows", lambda *a: (None, []))
        out = runner.run_cell(tiny_cell(name), SEED, 0.5, True,
                              torch.device("cpu"), time.time())
    return out, got[0]


@pytest.mark.parametrize("name", CELLS)
def test_span_windows_leave_the_four_as_they_were(name, monkeypatch):
    """Every span metric the cell lists reads a number; without the span
    windows none does, and the four windows' counts read the same: the
    launches and the work counts behind `mfu`, on the same seed."""
    on, d_on = _traced(name, monkeypatch, True)
    off, d_off = _traced(name, monkeypatch, False)
    assert on["correct"] and off["correct"]
    mine = {m for m in METRICS if name in METRICS[m]["workloads"]}
    assert mine and all(on["metrics"][m]["value"] is not None
                        for m in mine)
    assert not mine & set(off["metrics"])
    assert d_on.spans is not None and d_off.spans is None
    assert on["attempted"] == off["attempted"] + 2 * d_on.steps
    for m in set(on["metrics"]) | set(off["metrics"]):
        if m.startswith("launches_per_"):
            assert on["metrics"].get(m) == off["metrics"].get(m)
    assert (d_on.steps, d_on.launches) == (d_off.steps, d_off.launches)
    assert work.composite_walk(d_on) == work.composite_walk(d_off)
    assert work.composite_walk(d_on)["pairs"] > 0
    mfu = "mfu.serve" if "serve" in name else "mfu.train"
    flops = cells.metric_module(mfu).flops
    assert flops(d_on) == flops(d_off) > 0
