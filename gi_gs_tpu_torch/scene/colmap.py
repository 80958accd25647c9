"""COLMAP sparse-reconstruction parsers, binary and text (the port's own
copy of gi_gs_tpu/scene/colmap.py; ref scene/colmap_loader.py).

Implements the public COLMAP model format (cameras, images, points3D)
with numpy struct reads. `focals_from_camera` gives the focal lengths of
SIMPLE_PINHOLE and PINHOLE cameras, and of the radial, fisheye and OpenCV
models read as pinholes (their distortion ignored, as the reference does);
any other model raises.
"""
from __future__ import annotations

import collections
import os
import struct
from typing import Dict, Tuple

import numpy as np

CameraModel = collections.namedtuple("CameraModel", ["id", "name", "num_params"])
Camera = collections.namedtuple("Camera", ["id", "model", "width", "height", "params"])
Image = collections.namedtuple("Image", ["id", "qvec", "tvec", "camera_id", "name"])

_CAMERA_MODELS = {
    0: CameraModel(0, "SIMPLE_PINHOLE", 3),
    1: CameraModel(1, "PINHOLE", 4),
    2: CameraModel(2, "SIMPLE_RADIAL", 4),
    3: CameraModel(3, "RADIAL", 5),
    4: CameraModel(4, "OPENCV", 8),
    5: CameraModel(5, "OPENCV_FISHEYE", 8),
    6: CameraModel(6, "FULL_OPENCV", 12),
    7: CameraModel(7, "FOV", 5),
    8: CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    9: CameraModel(9, "RADIAL_FISHEYE", 5),
    10: CameraModel(10, "THIN_PRISM_FISHEYE", 12),
}


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _read(fid, n, fmt):
    return struct.unpack("<" + fmt, fid.read(n))


def read_cameras_binary(path: str) -> Dict[int, Camera]:
    cams = {}
    with open(path, "rb") as f:
        num = _read(f, 8, "Q")[0]
        for _ in range(num):
            cid, model_id, w, h = _read(f, 24, "iiQQ")
            model = _CAMERA_MODELS[model_id]
            params = np.array(_read(f, 8 * model.num_params, "d" * model.num_params))
            cams[cid] = Camera(cid, model.name, w, h, params)
    return cams


def read_images_binary(path: str) -> Dict[int, Image]:
    images = {}
    with open(path, "rb") as f:
        num = _read(f, 8, "Q")[0]
        for _ in range(num):
            iid = _read(f, 4, "i")[0]
            qvec = np.array(_read(f, 32, "dddd"))
            tvec = np.array(_read(f, 24, "ddd"))
            cam_id = _read(f, 4, "i")[0]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            n_pts = _read(f, 8, "Q")[0]
            f.seek(24 * n_pts, os.SEEK_CUR)  # skip 2D points (x, y, id)
            images[iid] = Image(iid, qvec, tvec, cam_id, name.decode())
    return images


def read_points3d_binary(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        num = _read(f, 8, "Q")[0]
        xyz = np.empty((num, 3))
        rgb = np.empty((num, 3))
        err = np.empty((num, 1))
        for i in range(num):
            data = _read(f, 43, "QdddBBBd")
            xyz[i] = data[1:4]
            rgb[i] = data[4:7]
            err[i] = data[7]
            track_len = _read(f, 8, "Q")[0]
            f.seek(8 * track_len, os.SEEK_CUR)
    return xyz, rgb, err


def read_cameras_text(path: str) -> Dict[int, Camera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            cams[int(el[0])] = Camera(
                int(el[0]), el[1], int(el[2]), int(el[3]),
                np.array([float(x) for x in el[4:]]))
    return cams


def read_images_text(path: str) -> Dict[int, Image]:
    images = {}
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip() and not l.startswith("#")]
    for i in range(0, len(lines), 2):  # every other line is the 2D point list
        el = lines[i].split()
        images[int(el[0])] = Image(
            int(el[0]), np.array([float(x) for x in el[1:5]]),
            np.array([float(x) for x in el[5:8]]), int(el[8]), el[9])
    return images


def read_points3d_text(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            xyz.append([float(x) for x in el[1:4]])
            rgb.append([float(x) for x in el[4:7]])
            err.append([float(el[7])])
    return np.array(xyz), np.array(rgb), np.array(err)


def focals_from_camera(cam: Camera) -> Tuple[float, float]:
    if cam.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "SIMPLE_RADIAL_FISHEYE"):
        return float(cam.params[0]), float(cam.params[0])
    if cam.model in ("PINHOLE", "OPENCV", "OPENCV_FISHEYE", "FULL_OPENCV"):
        return float(cam.params[0]), float(cam.params[1])
    raise ValueError(f"unsupported COLMAP camera model {cam.model}")
