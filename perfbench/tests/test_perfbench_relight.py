"""The relight cell and the light's readers (test_perfbench_run.py runs
every cell, these two included, at its tiny size): a relit run builds
one light per view from the second on (the program's counter
light_builds), and its traced line reads the light's span metrics;
`light_roofline.serve` counts the prefilter's least work as the
prefilter defines its levels, and every light reader reads nothing from
a program without the span light."""
from __future__ import annotations

import time
import types

import pytest
import torch

from perfbench import cells, loops, runner, spans, trace, work
from perfbench.sides import PROGRAM, Side
from gi_gs_tpu_torch.utils import timing
from gi_gs_tpu_torch.utils.timing import Span

from tiny import tiny_cell

SEED = 2 ** 31 + 53
CPU = torch.device("cpu")
LIGHT = ("light_device_ms.serve", "light_host_ms.serve",
         "light_roofline.serve")
ROOF = cells.metric_module("light_roofline.serve")


def test_every_relit_view_builds_one_light():
    cell = tiny_cell("hotdog.serve_relight")
    assert cell.traffic["relight_every"] == 1
    run = loops.serve_setup(Side(PROGRAM), cell, SEED, CPU)
    order = loops.view_order(len(run.cams), 4, SEED)
    cubes = []
    timing.start_spans()
    for i in range(4):
        loops.serve_at(run, order, i)
        cubes.append(run.state.cubemap)
    rec = timing.stop_spans()
    # the first view keeps the set-up light; each later one relights
    assert rec.counters["light_builds"] == 3
    assert [s.name for s in rec.spans if s.parent == 0] == \
        ["view", "light", "view", "light", "view", "light", "view"]
    assert all(not torch.equal(a, b) for a, b in zip(cubes, cubes[1:]))


def test_traced_relight_reads_the_light(monkeypatch):
    got = []
    six = trace.windows

    def keep(*args):
        data, res = six(*args)
        got.append(data)
        return data, res

    monkeypatch.setattr(trace, "windows", keep)
    out = runner.run_cell(tiny_cell("hotdog.serve_relight"), SEED, 0.5,
                          True, CPU, time.time())
    assert out["correct"], out["checks"]
    t = got[0]
    # windows A and B relight every view: one light a view, all roots
    assert spans.counter(t, "light_builds") == 1
    assert out["metrics"]["light_host_ms.serve"]["value"] > 0
    # the CPU launches no device operation: 0 ms, and so no roofline
    assert out["metrics"]["light_device_ms.serve"]["value"] == 0.0
    assert "light_roofline.serve" not in out["metrics"]
    assert t.inputs.cfg.train.light_base_res == 16


def _relit_trace(ops, builds=1, res=256, light=True):
    """One traced view: a root light span, then the view's."""
    s = [Span("view", 3, 0, 3, 1, 2_000, 9_000)]
    if light:
        s = [Span("light", 1, 0, 1, 1, 0, 1_000),
             Span("build_mips", 2, 1, 1, 1, 100, 900)] + s
    d = spans.SpanData(steps=1, step_s=1e-5, host=s,
                       counters={"host_syncs": 0, "light_builds": builds}
                       if light else {"host_syncs": 0},
                       spans=s, ops=ops,
                       calls=[o.launch_ns for o in ops])
    cfg = types.SimpleNamespace(train=types.SimpleNamespace(
        light_base_res=res))
    return types.SimpleNamespace(spans=d,
                                 inputs=types.SimpleNamespace(cfg=cfg))


OPS = [spans.Op("patch_fwd", 200, 10_200, 150, 1),     # 10 us in light
       spans.Op("composite_fwd", 3_000, 8_000, 2_500, 1)]


def test_light_readers_on_a_synthetic_trace():
    t = _relit_trace(OPS)
    read = lambda name: cells.metric_reader(name)(t)
    assert read("light_device_ms.serve") == pytest.approx(0.01)
    assert read("light_host_ms.serve") == pytest.approx(1e-3)
    flops, nbytes = ROOF.count(256)
    assert read("light_roofline.serve") == pytest.approx(
        100 * max(flops / work.F32_FLOPS, nbytes / work.HBM_BYTES_PER_S)
        / 10e-6)
    two = _relit_trace(OPS, builds=2)
    assert cells.metric_reader("light_roofline.serve")(two) == \
        pytest.approx(2 * read("light_roofline.serve"))


def test_light_readers_read_nothing_without_the_span():
    older = _relit_trace(OPS[1:], light=False)
    for name in LIGHT:
        read = cells.metric_reader(name)
        assert read(types.SimpleNamespace()) is None
        assert read(types.SimpleNamespace(spans=None)) is None
        assert read(older) is None
    # a light span that launched nothing on a device
    assert cells.metric_reader("light_roofline.serve")(
        _relit_trace(OPS[1:])) is None


def test_roofline_counts_the_prefilter_at_256():
    flops, nbytes = ROOF.count(256)
    assert flops == 2_256_224_256                     # ~2.25 GFLOP
    assert nbytes == 11_022_336                       # ~11 MB
    assert flops / work.F32_FLOPS * 1e3 == pytest.approx(0.0337, abs=1e-4)
    assert [r for r, _ in ROOF.levels(256)] == [256, 128, 64, 32, 16]


def test_roofline_levels_are_the_prefilters():
    """The yardstick's own levels and halos are those the port's prefilter
    builds (at light 16 and 64 here), and at 256 the halos 7, 20 and 28."""
    from gi_gs_tpu_torch.models import light as light_mod
    for res in (16, 64):
        spec, _ = light_mod.build_prefilter_tables(res, device="cpu")
        assert list(spec) == [
            ("dense",) if r <= ROOF.DENSE_MAX_RES else ("patch",
                                                        ROOF.halo(r, g))
            for r, g in ROOF.levels(res)]
    assert [ROOF.halo(r, g) for r, g in ROOF.levels(256) if r > 32] == \
        [7, 20, 28]
