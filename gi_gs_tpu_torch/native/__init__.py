"""Native (C++) COLMAP readers, built with g++ at first use (the port's own
copy of gi_gs_tpu/native: `colmap_io.cc` beside this file). The module is
built into `build/torch_native/` at the root of the checkout, under a name
keyed by the source and the Python headers, never into the package. If
it does not build, the failure is printed once and the Python readers of
`scene/colmap.py` are used. `reads` counts the files the native module
parsed."""
from __future__ import annotations

import collections
import hashlib
import importlib.util
import os
import subprocess
import sys
import sysconfig
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "colmap_io.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"

reads: collections.Counter = collections.Counter()
_mod = None
_tried = False


def _build() -> object:
    include = sysconfig.get_paths()["include"]
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(include.encode())
    so = BUILD_DIR / f"gigs_native_io_{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"gigs_native_io.{os.getpid()}.so"
        res = subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", f"-I{include}",
             str(SOURCE), "-o", str(tmp)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ exited {res.returncode}: "
                               f"{res.stderr.strip()[-400:]}")
        os.replace(tmp, so)
    spec = importlib.util.spec_from_file_location("gigs_native_io", so)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def get() -> Optional[object]:
    """The native module, or None if it could not be built."""
    global _mod, _tried
    if _mod is None and not _tried:
        _tried = True
        try:
            _mod = _build()
        except (OSError, RuntimeError, ImportError) as e:
            print(f"[gi_gs_tpu_torch.native] build failed ({e}); "
                  "using Python fallbacks", file=sys.stderr)
    return _mod


def read_points3d_binary(path: str):
    """points3D.bin -> (xyz [N, 3], rgb [N, 3], err [N, 1]) float64."""
    mod = get()
    if mod is None:
        from ..scene.colmap import read_points3d_binary as py_reader
        return py_reader(path)
    n, xyz_b, rgb_b, err_b = mod.read_points3d(path)
    reads["points3D.bin"] += 1
    xyz = np.frombuffer(xyz_b, np.float64).reshape(n, 3)
    rgb = np.frombuffer(rgb_b, np.float64).reshape(n, 3)
    err = np.frombuffer(err_b, np.float64).reshape(n, 1)
    return xyz, rgb, err


def read_images_binary(path: str):
    """images.bin -> {id: scene.colmap.Image}."""
    from ..scene.colmap import Image
    mod = get()
    if mod is None:
        from ..scene.colmap import read_images_binary as py_reader
        return py_reader(path)
    out = {}
    for rec in mod.read_images(path):
        out[rec["id"]] = Image(rec["id"], np.array(rec["qvec"]),
                               np.array(rec["tvec"]), rec["camera_id"],
                               rec["name"])
    reads["images.bin"] += 1
    return out
