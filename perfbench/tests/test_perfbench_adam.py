"""The Adam layer's readers: `adam_device_ms.train` is the device time of
the operations under the program's spans adam (the Gaussians' optimizer
and, in phase 2, the light's), `adam_roofline.train` the least bytes of
the layer, 28 B a trained element of the live Gaussians and the cubemap,
over that time; both read nothing from a program without the span."""
from __future__ import annotations

import types

import pytest

from perfbench import cells, spans, work
from gi_gs_tpu_torch.utils.timing import Span


def _trace(ops, phase=2, with_adam=True):
    """A traced step with the optimizer's adam span under optimizer and,
    in phase 2, the light's under light_optimizer."""
    s = [Span("step", 1, 0, 1, 1, 0, 10_000),
         Span("backward", 2, 1, 1, 1, 100, 2_000),
         Span("optimizer", 3, 1, 1, 1, 3_000, 5_000),
         Span("adam", 4, 3, 1, 1, 3_100, 3_200),
         Span("light_optimizer", 5, 1, 1, 1, 6_000, 7_000),
         Span("adam", 6, 5, 1, 1, 6_100, 6_200)]
    if not with_adam:
        s = [x for x in s if x.name != "adam"]
    d = spans.SpanData(steps=1, step_s=1e-5, host=s, counters={}, spans=s,
                       ops=ops, calls=[o.launch_ns for o in ops])
    fields = {"xyz": types.SimpleNamespace(numel=lambda: 3),
              "features_rest": types.SimpleNamespace(numel=lambda: 45),
              "alive": types.SimpleNamespace(numel=lambda: 1)}
    cfg = types.SimpleNamespace(train=types.SimpleNamespace(
        light_base_res=16))
    x = types.SimpleNamespace(
        cell=types.SimpleNamespace(config={"n_gaussians": 1000},
                                   traffic={"phase": phase}),
        fields={k: [v] for k, v in fields.items()}, cfg=cfg)
    return types.SimpleNamespace(spans=d, inputs=x)


OPS = [spans.Op("adam_gaussians", 3_300, 3_900, 3_150, 1),
       spans.Op("adam_light", 6_300, 6_400, 6_150, 1),
       spans.Op("update_stats", 4_000, 4_500, 3_500, 1)]


@pytest.mark.parametrize("phase", [1, 2])
def test_adam_readers_count_the_least_bytes(phase):
    t = _trace(OPS, phase)
    ms = cells.metric_reader("adam_device_ms.train")(t)
    assert ms == pytest.approx(0.7e-3)
    elements = 1000 * 48 + (6 * 16 ** 2 * 3 if phase == 2 else 0)
    assert work.trained_elements(t) == elements
    roof = cells.metric_module("adam_roofline.train")
    assert roof.read(t) == pytest.approx(
        100 * 28 * elements / work.HBM_BYTES_PER_S / 0.7e-6)


def test_adam_readers_read_nothing_without_the_span():
    read = lambda name, t: cells.metric_reader(name)(t)
    older = _trace(OPS, with_adam=False)
    for name in ("adam_device_ms.train", "adam_roofline.train"):
        assert read(name, older) is None
        assert read(name, types.SimpleNamespace()) is None
    # no inputs, or no device time under the span
    assert read("adam_roofline.train",
                types.SimpleNamespace(spans=_trace(OPS).spans)) is None
    assert read("adam_roofline.train", _trace(OPS[2:])) is None
