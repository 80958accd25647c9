"""The port's viewer protocol (cli/network_gui.py) and profiling utilities
(utils/profiling.py) against gi_gs_tpu's on the CPU: one viewer request
sent over a socketpair parsed by both `receive`s, the render byte stream
of `image_to_bytes`, and `StageTimes.report`'s rows."""
import json
import socket

import numpy as np
import pytest
import torch

from gi_gs_tpu.cli import network_gui as jax_gui
from gi_gs_tpu.utils import profiling as jax_profiling

from gi_gs_tpu_torch.cli import network_gui
from gi_gs_tpu_torch.utils import profiling

torch.set_num_threads(1)


def _message(rng, width=64, height=48):
    view = rng.normal(size=(4, 4)).astype(np.float32)
    view[3] = [0, 0, 0, 1]
    view[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    msg = {"resolution_x": width, "resolution_y": height,
           "view_matrix": view.T.reshape(-1).tolist(),
           "view_projection_matrix": rng.normal(size=16).tolist(),
           "fov_y": 0.7, "fov_x": 0.9, "train": True, "shs_python": False,
           "rot_scale_python": True, "keep_alive": True,
           "scaling_modifier": 0.5}
    body = json.dumps(msg).encode("utf-8")
    return len(body).to_bytes(4, "little") + body


def _receive(module, data, monkeypatch, **kw):
    a, b = socket.socketpair()
    with a, b:
        a.sendall(data)
        monkeypatch.setattr(module, "conn", b)
        return module.receive(**kw)


@pytest.mark.parametrize("size", [(64, 48), (0, 48)])
def test_receive_matches_jax(monkeypatch, size):
    data = _message(np.random.RandomState(0), *size)
    want = _receive(jax_gui, data, monkeypatch)
    got = _receive(network_gui, data, monkeypatch, device="cpu")
    assert got[1:] == want[1:]
    if size[0] == 0:
        assert got == (None,) * 6
        return
    cam, jcam = got[0], want[0]
    for k in ("w2c", "full_proj", "cam_pos"):
        np.testing.assert_array_equal(getattr(cam, k).numpy(),
                                      np.asarray(getattr(jcam, k)))
    for k in ("tanfovx", "tanfovy", "fx", "fy"):
        assert getattr(cam, k) == float(getattr(jcam, k)), k
    assert (cam.width, cam.height) == (jcam.width, jcam.height)


def test_send_frames_image_and_verify(monkeypatch):
    a, b = socket.socketpair()
    with a, b:
        monkeypatch.setattr(network_gui, "conn", a)
        network_gui.send(b"\x01\x02\x03", "scene_dir")
        got = b.recv(64)
    assert got == b"\x01\x02\x03" + (9).to_bytes(4, "little") + \
        b"scene_dir"


def test_image_to_bytes_matches_jax():
    img = np.random.RandomState(1).uniform(-0.2, 1.2, (3, 6, 5)).astype(
        np.float32)
    got = network_gui.image_to_bytes(torch.as_tensor(img))
    assert got == jax_gui.image_to_bytes(img)
    assert len(got) == 6 * 5 * 3


def test_stage_times_report_rows():
    rows = {"a": 0.002, "b": 0.0005}
    work = {"a": {"flops": 6.7e9, "bytes": 1e6}, "b": {"bytes": 3.35e9}}
    port, ref = profiling.StageTimes(), jax_profiling.StageTimes()
    port.times.update(rows)
    ref.times.update(rows)
    peaks = dict(peak_flops=1e12, peak_bw=1e11)
    assert port.report(work, **peaks) == ref.report(work, **peaks)
    # the default peaks are the H100's (f32 67 TFLOP/s, 3.35 TB/s)
    out = port.report(work)
    assert out["a"]["roofline_ms"] == pytest.approx(0.1)
    assert out["b"]["roofline_ms"] == pytest.approx(1.0)
    assert out["b"]["of_roofline"] == pytest.approx(0.5)


def test_time_fn_returns_the_last_output():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    dt, out = profiling.time_fn(fn, torch.ones(3), iters=3, warmup=2)
    assert len(calls) == 5 and dt >= 0
    assert torch.equal(out, torch.full((3,), 2.0))
    st = profiling.StageTimes()
    assert torch.equal(st.measure("s", fn, torch.ones(2)), torch.full(
        (2,), 2.0))
    assert set(st.report()) == {"s"}
