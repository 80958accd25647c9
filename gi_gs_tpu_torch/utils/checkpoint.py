"""Checkpoints and Gaussian PLY interchange (port of
gi_gs_tpu/utils/checkpoint.py).

* The port's state file `chkpnt{it}.pt` is a `torch.save` of plain
  tensors: {"params": {field: tensor}, "active_sh_degree",
  "max_sh_degree", "cubemap": [6, R, R, 3], "extra": dict}; a training
  checkpoint (`save_state`) adds "opt" ({group: {"mu", "nu", "count"}}),
  "light_opt", "stats" ({field: tensor}), "generator" (its state) and
  "iteration". `load_state` reads the parameters and cubemap of either
  kind (the render CLI), `load_train_state` the whole train state.
  `state_from_numpy` writes one from numpy arrays (a JAX state carried
  over field by field: the JAX pickle holds gi_gs_tpu classes), and
  `train_state_from_numpy` builds a train state from the numpy arrays of
  a JAX `TrainState`.
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
from .device import resolve_device


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


def _host(x):
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    return x.detach().cpu() if torch.is_tensor(x) else x


def save_state(path: str, state, extra: Optional[Dict] = None) -> None:
    """The whole train state (trainer.TrainState) to `path`."""
    extra = dict(extra or {})
    p = state.params
    blob = {
        "params": {k: _host(getattr(p, k)) for k in FIELDS},
        "active_sh_degree": int(p.active_sh_degree),
        "max_sh_degree": int(p.max_sh_degree),
        "cubemap": _host(state.cubemap),
        "opt": _host(state.opt_state),
        "light_opt": _host(state.light_opt_state),
        "stats": {k: _host(getattr(state.stats, k))
                  for k in state.stats.FIELDS},
        "generator": state.generator.get_state(),
        "iteration": int(extra.get("iteration", 0)),
        "extra": extra,
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(blob, path)


def _opt_to(opt: Dict, device) -> Dict:
    """The moments on `device`, contiguous as the CUDA Adam takes them (the
    CPU chain leaves some column-major)."""
    to = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                   device=device).contiguous()
    return {g: {"mu": to(st["mu"]), "nu": to(st["nu"]),
                "count": int(st["count"])} for g, st in opt.items()}


def train_state_from_numpy(fields: Dict[str, np.ndarray],
                           opt: Dict[str, Dict[str, np.ndarray]],
                           stats: Dict[str, np.ndarray], cubemap: np.ndarray,
                           active_sh_degree: int, max_sh_degree: int,
                           light_opt: Optional[Dict] = None, seed: int = 0,
                           device=None):
    """Weight carry for training: a JAX `TrainState` as numpy arrays ->
    the port's trainer.TrainState on `device` (default: the card).
    fields: the GaussianParams arrays; opt: {optax group label: {"mu",
    "nu", "count"}} (the group's ScaleByAdamState); stats: the
    DensifyStats arrays by field name; light_opt: the cubemap group's
    moments (zeros when absent). The densification generator is seeded
    with `seed` (JAX keys and torch generators draw different numbers)."""
    from ..train.densify import DensifyStats
    from ..train.trainer import TrainState
    device = resolve_device(device)
    params = params_from_numpy(fields, active_sh_degree, max_sh_degree,
                               device=device)
    cub = torch.as_tensor(np.asarray(cubemap, np.float32), device=device)
    if light_opt is None:
        light_opt = {"cubemap": {"mu": np.zeros(cub.shape, np.float32),
                                 "nu": np.zeros(cub.shape, np.float32),
                                 "count": 0}}
    return TrainState(
        params=params, opt_state=_opt_to(opt, device),
        stats=DensifyStats(*(torch.as_tensor(
            np.asarray(stats[k], np.float32), device=device)
            for k in DensifyStats.FIELDS)),
        cubemap=cub, light_opt_state=_opt_to(light_opt, device),
        generator=torch.Generator(device=device).manual_seed(seed))


def load_train_state(path: str, device):
    """-> (trainer.TrainState, extra) on `device`, from `save_state`."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    state = train_state_from_numpy(
        {k: v.numpy() for k, v in blob["params"].items()},
        blob["opt"], {k: v.numpy() for k, v in blob["stats"].items()},
        blob["cubemap"].numpy(), blob["active_sh_degree"],
        blob["max_sh_degree"], light_opt=blob["light_opt"], device=device)
    state.generator.set_state(blob["generator"])
    return state, blob["extra"]


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
    flat = lambda x: x.transpose(0, 2, 1).reshape(n, x.shape[1] * x.shape[2])
    f_dc = flat(get("features_dc"))
    f_rest = flat(get("features_rest"))
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
