"""Self-contained PLY reader/writer (port of gi_gs_tpu/scene/ply.py):
binary_little_endian and ascii vertex elements with float/int/uchar
properties — point clouds and the reference Gaussian schema."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_TYPES = {
    "float": np.float32, "float32": np.float32, "double": np.float64,
    "uchar": np.uint8, "uint8": np.uint8, "char": np.int8,
    "short": np.int16, "ushort": np.uint16,
    "int": np.int32, "int32": np.int32, "uint": np.uint32,
}
_NAMES = {np.dtype(np.float32): "float", np.dtype(np.uint8): "uchar",
          np.dtype(np.float64): "double", np.dtype(np.int32): "int"}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """{property_name: [N] array} of the 'vertex' element."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"not a PLY file: {path}")
        fmt = None
        n_vertex = 0
        props: List[Tuple[str, type]] = []
        in_vertex = False
        while True:
            line = f.readline().strip().decode()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, count = line.split()
                in_vertex = name == "vertex"
                if in_vertex:
                    n_vertex = int(count)
            elif line.startswith("property") and in_vertex:
                parts = line.split()
                props.append((parts[-1], _TYPES[parts[1]]))
            elif line == "end_header":
                break
        if fmt == "binary_little_endian":
            data = np.fromfile(f, dtype=np.dtype(props), count=n_vertex)
            return {n: data[n] for n, _ in props}
        if fmt == "ascii":
            raw = np.loadtxt(f, max_rows=n_vertex, ndmin=2)
            return {n: raw[:, i].astype(t) for i, (n, t) in enumerate(props)}
        raise ValueError(f"unsupported PLY format {fmt}")


def write_ply(path: str, names: List[str], arrays: List[np.ndarray],
              dtypes: List[type] | None = None) -> None:
    """Write a binary_little_endian vertex-element PLY."""
    n = len(arrays[0])
    dtypes = dtypes or [a.dtype for a in arrays]
    rec = np.empty(n, dtype=[(nm, np.dtype(dt).newbyteorder("<"))
                             for nm, dt in zip(names, dtypes)])
    for nm, a in zip(names, arrays):
        rec[nm] = a
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for nm, dt in zip(names, dtypes):
            f.write(f"property {_NAMES[np.dtype(dt)]} {nm}\n".encode())
        f.write(b"end_header\n")
        rec.tofile(f)


def store_point_cloud(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """storePly: xyz f32, zero normals, rgb uchar."""
    normals = np.zeros_like(xyz)
    names = ["x", "y", "z", "nx", "ny", "nz", "red", "green", "blue"]
    arrays = [xyz[:, 0], xyz[:, 1], xyz[:, 2],
              normals[:, 0], normals[:, 1], normals[:, 2],
              rgb[:, 0], rgb[:, 1], rgb[:, 2]]
    write_ply(path, names, arrays, [np.float32] * 6 + [np.uint8] * 3)


def fetch_point_cloud(path: str):
    """fetchPly: (points [N, 3], colors [N, 3] in [0, 1], normals)."""
    v = read_ply(path)
    pts = np.stack([v["x"], v["y"], v["z"]], axis=1)
    colors = np.stack([v["red"], v["green"], v["blue"]], axis=1) / 255.0
    if "nx" in v:
        normals = np.stack([v["nx"], v["ny"], v["nz"]], axis=1)
    else:
        normals = np.zeros_like(pts)
    return pts, colors, normals
