"""Checkpoints and Gaussian PLY interchange (port of
gi_gs_tpu/utils/checkpoint.py).

* The port's state file `chkpnt{it}.pt` is a `torch.save` of plain
  tensors: {"params": {field: tensor}, "active_sh_degree",
  "max_sh_degree", "cubemap": [6, R, R, 3], "extra": dict}.
  `state_from_numpy` writes one from numpy arrays (a JAX state carried
  over field by field: the JAX pickle holds gi_gs_tpu classes).
* save_gaussians_ply / load_gaussians_ply use the reference attribute
  schema (gaussian_model.py:397-465), so the `point_cloud.ply` written by
  the JAX trainer loads here. Only alive Gaussians are exported; loading
  re-pads to capacity.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..models.gaussians import FIELDS, GaussianParams, params_from_numpy
from ..scene import ply as ply_io


def state_from_numpy(fields: Dict[str, np.ndarray], cubemap: np.ndarray,
                     extra: Dict, model_path: str,
                     active_sh_degree: Optional[int] = None,
                     max_sh_degree: int = 3) -> str:
    """Write `model_path/chkpnt{extra['iteration']}.pt` from the field
    arrays of a GaussianParams and the cubemap base; returns the path."""
    if active_sh_degree is None:
        active_sh_degree = max_sh_degree
    blob = {
        "params": {k: torch.as_tensor(np.asarray(
            fields[k], bool if k == "alive" else np.float32)) for k in FIELDS},
        "active_sh_degree": int(active_sh_degree),
        "max_sh_degree": int(max_sh_degree),
        "cubemap": torch.as_tensor(np.asarray(cubemap, np.float32)),
        "extra": dict(extra),
    }
    os.makedirs(model_path, exist_ok=True)
    path = os.path.join(model_path,
                        f"chkpnt{int(extra.get('iteration', 0))}.pt")
    torch.save(blob, path)
    return path


def load_state(path: str, device):
    """-> (GaussianParams, cubemap tensor, extra) on `device`."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    params = params_from_numpy(
        {k: v.numpy() for k, v in blob["params"].items()},
        blob["active_sh_degree"], blob["max_sh_degree"], device=device)
    cubemap = blob["cubemap"].to(device=device, dtype=torch.float32)
    return params, cubemap, blob["extra"]


def save_gaussians_ply(path: str, params: GaussianParams) -> None:
    f = params.to_numpy()
    idx = np.nonzero(f["alive"])[0]
    n = len(idx)
    get = lambda k: f[k][idx]
    xyz = get("xyz")
    f_dc = get("features_dc").transpose(0, 2, 1).reshape(n, -1)
    f_rest = get("features_rest").transpose(0, 2, 1).reshape(n, -1)
    cols = [("x", xyz[:, 0]), ("y", xyz[:, 1]), ("z", xyz[:, 2])]
    cols += [(f"f_dc_{i}", f_dc[:, i]) for i in range(f_dc.shape[1])]
    cols += [(f"f_rest_{i}", f_rest[:, i]) for i in range(f_rest.shape[1])]
    cols += [("opacity", get("opacity")[:, 0])]
    cols += [(f"normal_{i}", get("normal")[:, i]) for i in range(3)]
    cols += [(f"albedo_{i}", get("albedo")[:, i]) for i in range(3)]
    cols += [("roughness", get("roughness")[:, 0]),
             ("metallic", get("metallic")[:, 0])]
    cols += [(f"scale_{i}", get("scaling")[:, i]) for i in range(3)]
    cols += [(f"rot_{i}", get("rotation")[:, i]) for i in range(4)]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    ply_io.write_ply(path, [c[0] for c in cols],
                     [c[1].astype(np.float32) for c in cols],
                     [np.float32] * len(cols))


def load_gaussians_ply(path: str, capacity: int, max_sh_degree: int = 3,
                       device=None) -> GaussianParams:
    v = ply_io.read_ply(path)
    n = len(v["x"])
    K = (max_sh_degree + 1) ** 2

    def grab(prefix, count):
        return np.stack([v[f"{prefix}_{i}"] for i in range(count)], axis=1)

    def pad(x, fill=0.0):
        x = np.asarray(x, np.float32)
        return np.concatenate(
            [x, np.full((capacity - n,) + x.shape[1:], fill, np.float32)], 0)

    rot = np.concatenate([grab("rot", 4).astype(np.float32),
                          np.tile(np.array([[1, 0, 0, 0]], np.float32),
                                  (capacity - n, 1))], 0)
    fields = {
        "xyz": pad(np.stack([v["x"], v["y"], v["z"]], axis=1)),
        "features_dc": pad(grab("f_dc", 3).reshape(n, 3, 1)
                           .transpose(0, 2, 1)),
        "features_rest": pad(grab("f_rest", 3 * (K - 1))
                             .reshape(n, 3, K - 1).transpose(0, 2, 1)),
        "opacity": pad(v["opacity"][:, None]),
        "normal": pad(grab("normal", 3)),
        "albedo": pad(grab("albedo", 3)),
        "roughness": pad(v["roughness"][:, None]),
        "metallic": pad(v["metallic"][:, None]),
        "scaling": pad(grab("scale", 3), fill=-10.0),
        "rotation": rot,
        "alive": np.arange(capacity) < n,
    }
    return params_from_numpy(fields, max_sh_degree, max_sh_degree,
                             device=device)
