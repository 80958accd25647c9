"""The yardstick's work counts on shapes small enough to count by hand,
and the readers that turn them into shares."""
from __future__ import annotations

import types

import pytest
import torch

from perfbench import cells, trace, work
from perfbench.sides import REFERENCE, Side

N_LIST = 8          # instances in the one tile, all covering every pixel
OPACITY = 0.8       # T after k of them: 0.2^k; the 6th takes T under 1e-4


def _one_tile():
    side = Side(REFERENCE)
    r = side.config.Config().raster            # one 16 x 64 tile
    table = torch.zeros((N_LIST, 21))
    table[:, 0], table[:, 1] = 32.0, 8.0        # centred, conic 0: G = 1
    table[:, 5] = OPACITY
    b = types.SimpleNamespace(ids=torch.arange(N_LIST, dtype=torch.int32),
                              tile_start=torch.zeros(1, dtype=torch.int32),
                              tile_count=torch.full((1,), N_LIST,
                                                    dtype=torch.int32))
    cam = types.SimpleNamespace(height=r.tile_h, width=r.tile_w)
    return r, cam, b, table


def _trace(device_ms, steps=2, window_s=0.01, **cache):
    ev = [trace.DeviceEvent(name, start, ms * 1e3)
          for start, (name, ms) in enumerate(device_ms)]
    return trace.TraceData(steps=steps, window_s=window_s, device=ev,
                           step_s=window_s / steps, cache=cache)


def test_composite_counts_pairs_up_to_termination():
    r, cam, b, table = _one_tile()
    w = work.composite_walk_of(r, cam, b, table)
    P = r.tile_h * r.tile_w
    # 0.2^5 = 3.2e-4 >= 1e-4 contributes; 0.2^6 = 6.4e-5 ends the walk
    assert w["pairs"] == 6 * P
    assert w["contrib"] == 5 * P
    assert (w["instances"], w["rows"], w["tiles"], w["pixels"]) == \
        (N_LIST, N_LIST, 1, P)
    assert work.composite_flops(w, "fwd") == 13 * 6 * P + 32 * 5 * P
    assert work.composite_flops(w, "bwd") == 13 * 6 * P + 50 * 5 * P
    t = _trace([], composite_walk=w)
    common = N_LIST * 21 * 4 + N_LIST * 4 + 8
    fwd = cells.metric_module("composite_fwd_roofline.serve").count(t)
    bwd = cells.metric_module("composite_bwd_roofline.train").count(t)
    assert fwd == (common + P * 4 * 17, 13 * 6 * P + 32 * 5 * P)
    assert bwd == (common + P * 4 * 22 + N_LIST * 21 * 4,
                   13 * 6 * P + 50 * 5 * P)


def test_bound_is_the_larger_of_bytes_and_operations():
    assert work.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 67e12) == pytest.approx(1.0)
    assert work.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_roofline_share_of_the_first_launch():
    # 3.35e9 bytes: 1 ms at the HBM's rate; the launch takes 4 ms
    t = _trace([("(anonymous namespace)::composite_bwd_kernel(float const*)",
                 4.0), ("void composite_bwd_kernel<4>(int)", 1.0)])
    assert work.roofline(t, "composite_bwd", 1,
                         lambda t: (3.35e9, 0)) == pytest.approx(25.0)
    assert work.roofline(t, "composite_fwd", 1, lambda t: (1, 1)) is None
    assert work.roofline(t, "composite_bwd", 1, lambda t: None) is None


def test_march_roofline_sums_its_ssao_and_ssr_launches():
    # 67e9 operations a march: 1 ms each at the f32 peak
    m = {"samples": 67e9 / 20, "keys": 0, "mode": "exact", "pixels": 0,
         "directions": 0}
    t = _trace([("void (anonymous namespace)::gi_march_kernel<false>(int)",
                 2.0), ("gi_march_coherent_kernel<true>(int)", 9.0),
                ("void (anonymous namespace)::gi_march_kernel<true>(int)",
                 2.0)], march_walks=[m, m])
    read = cells.metric_reader("gi_march_roofline.serve")
    assert read(t) == pytest.approx(50.0)
    assert read(_trace([], march_walks=[m, m])) is None
    assert cells.metric_module("gi_march_roofline.serve").count(t)[0] == 0


def test_mfu_and_busy_time():
    t = _trace([("a", 1.0), ("b", 2.0)], steps=2, window_s=0.01)
    assert work.mfu(t, 67e9 * 2.5) == pytest.approx(50.0)  # 2.5 of 5 ms
    assert work.mfu(t, None) is None
    # intervals [0, 1 ms] and [1 us, 2.001 ms] overlap: 2.001 ms busy
    assert t.busy_s == pytest.approx(2.001e-3)
    assert t.launches == 2
    # 1.0005 ms busy a step of 5 ms in the plain window: 79.99% idle
    for name in ("device_idle.train", "device_idle.serve"):
        assert cells.metric_reader(name)(t) == pytest.approx(79.99)
        assert cells.metric_reader(name)(_trace([])) is None


def test_idle_gaps_name_what_the_host_did():
    dev = [trace.DeviceEvent("k", 0.0, 10.0), trace.DeviceEvent("k", 30.0, 5.0),
           trace.DeviceEvent("k", 50.0, 5.0)]
    host = [trace.HostEvent("aten::mul", 12.0, 14.0),
            trace.HostEvent("cudaLaunchKernel", 36.0, 60.0)]
    gaps = trace.idle_gaps(dev, host)
    assert gaps == pytest.approx({"aten::mul": 20e-6,
                                  "cudaLaunchKernel": 15e-6})


def test_reduction_roofline_counts_the_least_bytes():
    mod = cells.metric_module("reduce_instance_grads_roofline.train")
    # a garden p1 step's rows (4,194,304 Gaussians, 6,129,957 rows): the
    # kernel's own 0.279 ms bound (PERF.md's table), within 5%
    bound_ms = mod.nbytes(6129957, 4194304) / work.HBM_BYTES_PER_S * 1e3
    assert bound_ms == pytest.approx(0.279, rel=0.05)
    assert mod.nbytes(10, 4) == 10 * (21 * 4 + 4) + 4 * 21 * 4

    def gbuffer(offsets, cap):
        return {"binning": types.SimpleNamespace(
                    offsets=torch.tensor(offsets, dtype=torch.int32)),
                "raster": types.SimpleNamespace(cap_instances=cap)}

    # the first step's three launches, 2 ms in all; the second's are not
    # counted. 3 Gaussians, one unseen (a row all the same), 7 rows
    step = [("void (anonymous namespace)::reduce_scan_kernel<10>(float "
             "const*, long long const*)", 1.0),
            ("(anonymous namespace)::reduce_carry_kernel<10>(float*)", 0.5),
            ("(anonymous namespace)::reduce_diff_kernel(float const*)",
             0.5)]
    t = _trace(step + [(n, 9.0) for n, _ in step],
               gbuffer=gbuffer([0, 4, 5, 7], 64))
    assert mod.count(t) == (mod.nbytes(7, 3), 21 * 7)
    assert mod.read(t) == pytest.approx(
        100 * work.bound_s(*mod.count(t)) / 2e-3)
    # rows past the instance capacity are not there to read
    t.cache["gbuffer"] = gbuffer([0, 4, 5, 7], 6)
    assert mod.count(t) == (mod.nbytes(6, 3), 21 * 6)
    assert mod.read(_trace(step[:2], gbuffer=gbuffer([0, 1], 8))) is None
    t.cache["gbuffer"] = gbuffer([0], 8)
    assert mod.read(t) is None
