"""SIBR live-viewer socket protocol (port of gi_gs_tpu/cli/network_gui.py;
ref gaussian_renderer/network_gui.py, present but never called by the
fork's train.py; kept for interface parity with the 3DGS viewer).

Framing: the viewer sends a 4-byte little-endian length and a JSON
request; the reply is the raw RGB bytes of the render, then a
length-prefixed verify string. The listening socket is opened by `init`,
not at import.
"""
from __future__ import annotations

import json
import math
import socket
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..scene.cameras import Camera, _f32
from ..utils.device import resolve_device

host = "127.0.0.1"
port = 6009

conn: Optional[socket.socket] = None
addr = None
listener: Optional[socket.socket] = None


def init(wish_host: str = "127.0.0.1", wish_port: int = 6009) -> None:
    """Open the non-blocking listening socket on (wish_host, wish_port)."""
    global host, port, listener
    host, port = wish_host, wish_port
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.bind((host, port))
    listener.listen()
    listener.settimeout(0)


def try_connect() -> None:
    """Accept a waiting viewer, if there is one."""
    global conn, addr
    try:
        conn, addr = listener.accept()
        print(f"\nConnected by {addr}")
        conn.settimeout(None)
    except BlockingIOError:
        pass


def _recv_exact(n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = conn.recv(n - len(buf))
        if not part:
            raise ConnectionError("the viewer closed the connection")
        buf += part
    return buf


def read() -> Dict:
    n = int.from_bytes(_recv_exact(4), "little")
    return json.loads(_recv_exact(n).decode("utf-8"))


def send(image_bytes: Optional[bytes], verify: str) -> None:
    if image_bytes is not None:
        conn.sendall(image_bytes)
    conn.sendall(len(verify).to_bytes(4, "little"))
    conn.sendall(bytes(verify, "ascii"))


def receive(device=None) -> Tuple[Optional[Camera], Optional[bool],
                                  Optional[bool], Optional[bool],
                                  Optional[bool], Optional[float]]:
    """One viewer request as (camera on `device` (default: the card),
    train, shs_python, rot_scale_python, keep_alive, scaling_modifier);
    all None for a 0-sized view (ref network_gui.receive:63-117). The
    viewer sends OpenGL-flipped, transposed (row-vector) view and
    projection matrices."""
    msg = read()
    width, height = msg["resolution_x"], msg["resolution_y"]
    if width == 0 or height == 0:
        return None, None, None, None, None, None
    dev = resolve_device(device)
    w2c_t = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
    w2c_t[:, 1] *= -1
    w2c_t[:, 2] *= -1
    fullproj_t = np.array(msg["view_projection_matrix"],
                          np.float32).reshape(4, 4)
    fullproj_t[:, 1] *= -1
    w2c, full_proj = w2c_t.T, fullproj_t.T
    fovy, fovx = msg["fov_y"], msg["fov_x"]
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                  device=dev)
    cam = Camera(
        w2c=t(w2c), full_proj=t(full_proj),
        cam_pos=t(np.linalg.inv(w2c)[:3, 3]),
        tanfovx=_f32(math.tan(fovx * 0.5)),
        tanfovy=_f32(math.tan(fovy * 0.5)),
        fx=_f32(width / (2 * math.tan(fovx * 0.5))),
        fy=_f32(height / (2 * math.tan(fovy * 0.5))),
        width=int(width), height=int(height))
    return (cam, bool(msg["train"]), bool(msg["shs_python"]),
            bool(msg["rot_scale_python"]), bool(msg["keep_alive"]),
            float(msg["scaling_modifier"]))


def image_to_bytes(image: torch.Tensor) -> bytes:
    """[3, H, W] float render -> the viewer's HWC uint8 byte stream."""
    arr = image.detach().to("cpu", torch.float32).numpy()
    arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    return arr.transpose(1, 2, 0).tobytes()
