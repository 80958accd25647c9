"""The timing module's two modes on the render and training paths
(`gi_gs_tpu_torch/utils/timing.py`): with both off, nothing is recorded
and nothing launched; the fenced stage totals keep their stage names;
span mode gives the tree of a step or view (roots, parents, root ids,
a worker thread's span under `backward`), its host syncs and the
instances binning made, on the clock of the profiler's events.

The tests marked `cuda` need a card and skip without one. This file
imports no JAX, so on a machine with a card:
    python -m pytest --noconftest -m cuda tests/test_torch_spans.py"""
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from gi_gs_tpu_torch import config as cfg_mod
from gi_gs_tpu_torch.cli import render_cli
from gi_gs_tpu_torch.models.gaussians import create_from_points
from gi_gs_tpu_torch.ops import shading
from gi_gs_tpu_torch.ops.rasterize import RasterConfig
from gi_gs_tpu_torch.ops.rasterize.pipeline import count_instances
from gi_gs_tpu_torch.ops.screen_space import GIParams
from gi_gs_tpu_torch.scene.cameras import make_camera
from gi_gs_tpu_torch.train import optim, trainer
from gi_gs_tpu_torch.utils import device as device_mod
from gi_gs_tpu_torch.utils import timing

W, H = 64, 48
CAP = 512
EXTENT = 1.0
ITERATION = 500             # past densification, before an opacity reset
SIZES = dict(tile_h=8, tile_w=32, cap_instances=1 << 14, cap_tile=256,
             chunk=8)

# the stage names each path's fenced totals have
RASTER = {"activations", "preprocess", "binning", "composite", "derive",
          "post"}
PHASE1 = RASTER | {"loss", "backward", "optimizer", "densify"}
PHASE2 = PHASE1 | {"build_mips", "shading", "ssr", "env_tv",
                   "light_optimizer"}
VIEW = RASTER | {"prefilter_tables", "build_mips", "ssao",
                 "shading", "ssr"}
# host syncs (sync.* spans) of each path, by site
SYNCS1 = {"sync.preprocess_scalar": 4, "sync.bilateral_weights": 1,
          "sync.ssim_window": 1}
SYNCS2 = {"sync.preprocess_scalar": 4, "sync.bilateral_weights": 1,
          "sync.view_dirs_inv": 1}
SYNCS_VIEW = {"sync.preprocess_scalar": 4, "sync.bilateral_weights": 1,
              "sync.normal_bg": 1, "sync.view_dirs_inv": 1}


@pytest.fixture(autouse=True)
def small_lut():
    """The env-BRDF LUT integrated over 64 samples, not 4096 (seconds of
    host numpy less); the device copies dropped before and after."""
    full = shading._brdf_lut_np
    mp = pytest.MonkeyPatch()
    mp.setattr(shading, "_brdf_lut_np", lambda res=256, samples=0:
               full(res, 64))
    shading._brdf_lut_quad.cache_clear()
    _drop_luts()
    yield
    mp.undo()
    shading._brdf_lut_quad.cache_clear()
    _drop_luts()


def _drop_luts():
    for key in [k for k in device_mod._constants
                if k[0] is shading._brdf_lut_quad]:
        del device_mod._constants[key]


@pytest.fixture(autouse=True)
def modes_off():
    yield
    timing.stop()
    timing.stop_spans()


def port_cfg(indirect=False):
    c = cfg_mod.Config()
    c.model = cfg_mod.ModelConfig(capacity=CAP)
    c.train = cfg_mod.TrainConfig(light_base_res=16, indirect=indirect,
                                  metallic=True)
    c.raster = RasterConfig(**SIZES)
    c.gi = GIParams(step=4, start=2, delta=0.25)
    return c


class Scene:
    def __init__(self, dev, seed=1, n=300):
        rng = np.random.RandomState(seed)
        pts = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
        pts[:, 2] += 2.5
        cols = rng.uniform(0.2, 0.9, (n, 3)).astype(np.float32)
        self.params = create_from_points(pts, cols, capacity=CAP,
                                         max_sh_degree=1, device=dev)
        self.params.opacity[:n] = torch.as_tensor(
            rng.uniform(-1.0, 2.5, (n, 1)), dtype=torch.float32,
            device=dev)
        self.cam = make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, W, H,
                               device=dev)
        ys, xs = np.mgrid[0:H, 0:W] / W
        img = np.stack([0.5 + 0.4 * np.sin(5 * xs + 3 * ys + p)
                        for p in (0.3, 1.9, 4.2)]).astype(np.float32)
        self.image = torch.as_tensor(img, device=dev)
        self.alpha = torch.ones((1, H, W), device=dev)
        self.bg = torch.zeros(3, device=dev)
        self.cubemap = torch.as_tensor(
            rng.uniform(0, 1.5, (6, 16, 16, 3)), dtype=torch.float32,
            device=dev)


def make_step(scene, phase, cfg, dev):
    tx = optim.build_optimizer(cfg.opt, EXTENT)
    state = trainer.make_train_state(cfg, scene.params, EXTENT, tx=tx)
    state = state.replace(cubemap=scene.cubemap)
    if phase == 1:
        step = trainer.make_phase1_step(cfg, EXTENT, tx)
    else:
        step = trainer.make_phase2_step(
            cfg, EXTENT, tx, optim.build_light_optimizer(cfg.opt), dev)
    return state, lambda st: step(st, scene.cam, scene.image, scene.alpha,
                                  scene.bg, ITERATION)


def view(scene, cfg, light=None):
    state = type("S", (), {"params": scene.params,
                           "cubemap": scene.cubemap})()
    return render_cli.render_pbr_view(cfg, state, scene.cam, scene.bg,
                                      light=light)


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def sync_sites(spans):
    got = {}
    for s in spans:
        if s.name.startswith("sync."):
            got[s.name] = got.get(s.name, 0) + 1
    return got


# ---------------------------------------------------------------------------
# Both modes off
# ---------------------------------------------------------------------------

def test_off_records_nothing_and_launches_nothing():
    x = torch.ones(4)
    n = x.sum().to(torch.int64)

    @timing.spanned("f")
    def f(v):
        return v

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timing.stage("preprocess", x.device), timing.span("step"):
            with timing.span("sync.site"):
                f(x)
            timing.count("instances", n)
    assert list(prof.events()) == []
    assert timing.stop() == {}
    assert timing.stop_spans() == timing.Records([], {})

    # a served view and a phase-1 step with both modes off leave nothing
    scene = Scene("cpu")
    view(scene, port_cfg())
    state, step = make_step(scene, 1, port_cfg(), "cpu")
    step(state)
    assert timing.stop() == {} and timing.stop_spans().spans == []


def test_count_adds_on_the_device_in_span_mode_only():
    t = torch.tensor(7, dtype=torch.int32)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as off:
        timing.count("instances", t)
    assert list(off.events()) == []
    timing.start_spans()
    timing.count("instances", t)
    timing.count("instances", t)
    counter = timing._rec.device["instances"]
    assert torch.is_tensor(counter) and counter.dtype == torch.int64
    assert timing.stop_spans().counters == {"host_syncs": 0,
                                            "instances": 14}


# ---------------------------------------------------------------------------
# Fenced stage totals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path,names", [
    ("view", VIEW), ("phase1", PHASE1), ("phase2", PHASE2),
    ("phase2_indirect", PHASE2 | {"ssao"})])
def test_fenced_stage_names(path, names):
    scene = Scene("cpu")
    cfg = port_cfg(indirect=path == "phase2_indirect")
    if path == "view":
        timing.start()
        view(scene, cfg)
    else:
        state, step = make_step(scene, 1 if path == "phase1" else 2, cfg,
                                "cpu")
        timing.start()
        step(state)
    totals = timing.stop()
    assert set(totals) == names
    assert all(v >= 0 for v in totals.values())


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

def _check_tree(spans, root_name):
    ids = {s.id: s for s in spans}
    roots = [s for s in spans if s.parent == 0]
    assert [r.name for r in roots] == [root_name]
    root = roots[0]
    assert root.root == root.id
    for s in spans:
        assert s.root == root.id
        if s.parent:
            p = ids[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    return ids, root


@pytest.mark.parametrize("phase,syncs", [(1, SYNCS1), (2, SYNCS2)])
def test_step_span_tree(phase, syncs):
    scene = Scene("cpu")
    state, step = make_step(scene, phase, port_cfg(), "cpu")
    timing.start_spans()
    step(state)
    rec = timing.stop_spans()
    ids, root = _check_tree(rec.spans, "step")
    names = by_name(rec.spans)
    want = PHASE1 if phase == 1 else PHASE2
    assert want <= set(names)
    assert set(names) - want == {"step", "composite_bwd", "sh", "sh_bwd",
                                 "adam"} \
        | set(syncs) | ({"light_bwd"} if phase == 2 else set())
    parent = lambda s: ids[s.parent].name
    assert {parent(s) for s in names["composite_bwd"]} == {"backward"}
    assert {parent(s) for s in names["sh"]} == {"activations"}
    assert {parent(s) for s in names["sh_bwd"]} == {"backward"}
    assert [parent(s) for s in names["adam"]] == (
        ["optimizer"] if phase == 1 else ["optimizer", "light_optimizer"])
    assert parent(names["preprocess"][0]) == "step"
    assert {parent(s) for s in names["sync.preprocess_scalar"]} == \
        {"preprocess"}
    if phase == 2:
        assert {parent(s) for s in names["light_bwd"]} == {"backward"}
        assert len(names["light_bwd"]) >= 4
    assert sync_sites(rec.spans) == syncs
    assert rec.counters["host_syncs"] == sum(syncs.values())


def test_view_span_tree_and_instances():
    scene = Scene("cpu")
    cfg = port_cfg()
    light = render_cli.build_light(cfg, scene.cubemap)
    timing.start_spans()
    view(scene, cfg, light)
    view(scene, cfg, light)
    rec = timing.stop_spans()
    roots = [s for s in rec.spans if s.parent == 0]
    assert [r.name for r in roots] == ["view", "view"]
    for r in roots:
        mine = [s for s in rec.spans if s.root == r.id]
        _check_tree(mine, "view")
        assert sync_sites(mine) == SYNCS_VIEW
    assert rec.counters["host_syncs"] == 2 * sum(SYNCS_VIEW.values())
    p, cam = scene.params, scene.cam
    want = count_instances(p.xyz, p.get_covariance(1.0), cam.w2c,
                           cam.full_proj, cam.tanfovx, cam.tanfovy, H, W,
                           cfg.raster, opacity=p.get_opacity())
    assert want > 0
    assert rec.counters["instances"] == 2 * want


def test_light_span_tree_and_light_builds():
    """A relight (build_light before its view) is a root span light; a
    view that builds its own light holds it under view. Each light holds
    the stages prefilter_tables and build_mips, and counts one
    light_builds in span mode; outside span mode nothing is counted."""
    scene = Scene("cpu")
    cfg = port_cfg()
    light = render_cli.build_light(cfg, scene.cubemap)
    timing.start_spans()
    view(scene, cfg, light)
    rec = timing.stop_spans()
    assert "light_builds" not in rec.counters
    assert "light" not in by_name(rec.spans)

    timing.start_spans()
    relit = render_cli.build_light(cfg, scene.cubemap * 0.5)
    view(scene, cfg, relit)
    view(scene, cfg)
    rec = timing.stop_spans()
    ids = {s.id: s for s in rec.spans}
    roots = [s for s in rec.spans if s.parent == 0]
    assert [r.name for r in roots] == ["light", "view", "view"]
    _check_tree([s for s in rec.spans if s.root == roots[0].id], "light")
    lights = by_name(rec.spans)["light"]
    assert [ids[s.parent].name if s.parent else None for s in lights] == \
        [None, "view"]
    assert lights[1].root == roots[2].id
    for s in lights:
        kids = sorted((k for k in rec.spans if k.parent == s.id),
                      key=lambda k: k.start_ns)
        assert [k.name for k in kids] == ["prefilter_tables", "build_mips"]
    assert rec.counters["light_builds"] == 2
    timing.start_spans()
    timing.count("light_builds", 1)
    timing.count("light_builds", 1)
    assert timing.stop_spans().counters == {"host_syncs": 0,
                                            "light_builds": 2}
    render_cli.build_light(cfg, scene.cubemap)
    assert timing.stop_spans() == timing.Records([], {})


def test_worker_thread_span_takes_the_backward_parent():
    timing.start_spans()
    with timing.span("step"):
        with timing.span("backward"):
            worker = threading.Thread(target=_worker_span)
            worker.start()
            worker.join(30)
            assert not worker.is_alive()
        with timing.span("optimizer"):
            pass
    spans = by_name(timing.stop_spans().spans)
    step, bwd = spans["step"][0], spans["backward"][0]
    w = spans["composite_bwd"][0]
    assert (w.parent, w.root) == (bwd.id, step.id)
    assert w.thread != bwd.thread == threading.get_native_id()
    assert spans["optimizer"][0].parent == step.id


def _worker_span():
    with timing.span("composite_bwd"):
        time.sleep(0.001)


def test_spans_are_on_the_profilers_clock():
    """A span around a matmul holds the profiler's aten::mm event, both
    read on time.time_ns()'s clock: the kineto event's own start and
    end, and the trace's start plus the event's time_range."""
    a = torch.randn(256, 256)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        timing.start_spans()
        time.sleep(0.002)
        with timing.span("mm"):
            a @ a
        time.sleep(0.002)
        rec = timing.stop_spans()
    s, = rec.spans
    kr = prof.profiler.kineto_results
    mm = [e for e in kr.events() if e.name() == "aten::mm"]
    assert len(mm) == 1
    assert s.start_ns <= mm[0].start_ns() <= mm[0].end_ns() <= s.end_ns
    fe, = [e for e in prof.events() if e.name == "aten::mm"]
    t0 = kr.trace_start_ns()
    assert s.start_ns <= t0 + fe.time_range.start * 1e3
    assert t0 + fe.time_range.end * 1e3 <= s.end_ns


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sleep_kernel_after_a_gap_lands_in_its_span(cuda):
    """A kernel launched in a span after the device was idle starts on
    the device after the span opened, and its launch (the runtime call
    of the same correlation id) lies inside the span. The device's
    timestamps are converted to the host's clock by the profiler, which
    leaves tens of microseconds of skew (a kernel has read ~50 us before
    its launch): the span opens 5 ms before the launch, and the kernel's
    start is held within 1 ms of it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        timing.start_spans()
        time.sleep(0.02)
        with timing.span("sleepy"):
            time.sleep(0.005)
            torch.cuda._sleep(2_000_000)
        torch.cuda.synchronize()
        rec = timing.stop_spans()
    s, = rec.spans
    events = list(prof.profiler.kineto_results.events())
    kern = [e for e in events if str(e.device_type()).endswith("CUDA")]
    assert len(kern) == 1, [e.name() for e in kern]
    k = kern[0]
    assert k.duration_ns() > 100_000
    launch = [e for e in events if not str(e.device_type()).endswith("CUDA")
              and e.correlation_id() == k.correlation_id()
              and e.name().startswith("cuda")]
    assert len(launch) == 1, [e.name() for e in events]
    assert s.start_ns <= launch[0].start_ns() <= s.end_ns
    assert k.start_ns() >= s.start_ns
    assert abs(k.start_ns() - launch[0].start_ns()) < 1_000_000


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["phase1", "phase2", "view"])
def test_every_sync_is_in_a_sync_span(cuda, path):
    """Under torch.cuda.set_sync_debug_mode, every synchronising call of
    a phase-1 step, a phase-2 step and a served view falls inside a
    sync.* span, and host_syncs counts exactly those calls."""
    scene = Scene(cuda)
    cfg = port_cfg()
    if path == "view":
        light = render_cli.build_light(cfg, scene.cubemap)
        run = lambda: view(scene, cfg, light)
    else:
        state, step = make_step(scene, 1 if path == "phase1" else 2, cfg,
                                cuda)
        run = lambda: step(state)
    run()                               # first-use builds and copies
    torch.cuda.synchronize()
    inside, outside = [], []

    def hook(message, *args, **kwargs):
        if "synchroniz" not in str(message) or "prototype" in str(message):
            return
        stack = timing._rec.stacks.get(threading.get_ident(), [])
        where = [s.name for s in stack]
        (inside if where and where[-1].startswith("sync.")
         else outside).append(where)

    timing.start_spans()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(2):
                run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    rec = timing.stop_spans()
    assert outside == []
    assert len(inside) == rec.counters["host_syncs"] > 0
