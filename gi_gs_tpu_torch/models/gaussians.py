"""Capacity-padded Gaussian parameters (port of
gi_gs_tpu/models/gaussians.py): raw pre-activation tensors of a fixed
capacity with an `alive` mask, and the activations the renderer reads.

Raw layout (ref gaussian_model.py:59-80): xyz [C,3], features_dc [C,1,3],
features_rest [C,K-1,3], opacity [C,1] (sigmoid), normal [C,3] (L2),
albedo [C,3], roughness [C,1], metallic [C,1] (sigmoid), scaling [C,3]
(exp), rotation [C,4] (normalised quat, w-first), alive [C] bool.

Densification writes clones/splits into dead capacity slots and clears
`alive` bits (train/densify.py); when the live population outgrows the
capacity, `grow_params` re-pads every field to a larger one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..ops import sh as sh_ops
from ..ops.knn import mean_knn_dist2
from ..utils import math_utils
from ..utils.device import resolve_device

FIELDS = ("xyz", "features_dc", "features_rest", "opacity", "normal",
          "albedo", "roughness", "metallic", "scaling", "rotation", "alive")


def _rounded(fn, x: torch.Tensor) -> torch.Tensor:
    """fn(x) evaluated in f64 and rounded to f32: the same bits on the CPU
    and the card, and wherever an element sits in PyTorch's CPU vector
    loop (its f32 `sigmoid` gives an element of a loop's scalar tail other
    bits). Used for the two activations preprocess reads (opacity and
    scale), where the first CPU render of a process was seen to move
    (tools/parity_processes.py, PERF.md)."""
    return fn(x.double()).float()


@dataclasses.dataclass
class GaussianParams:
    xyz: torch.Tensor
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    opacity: torch.Tensor
    normal: torch.Tensor
    albedo: torch.Tensor
    roughness: torch.Tensor
    metallic: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    alive: torch.Tensor
    active_sh_degree: int = 0
    max_sh_degree: int = 3

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    @property
    def num_alive(self) -> torch.Tensor:
        return self.alive.sum()

    def get_rotation(self) -> torch.Tensor:
        return math_utils.normalize(self.rotation)

    def get_scaling(self) -> torch.Tensor:
        return _rounded(torch.exp, self.scaling)

    def get_opacity(self) -> torch.Tensor:
        # Dead (padding) slots must not render: force opacity to 0.
        return _rounded(torch.sigmoid, self.opacity) * self.alive[:, None]

    def get_normal(self) -> torch.Tensor:
        return math_utils.normalize(self.normal)

    def get_albedo(self) -> torch.Tensor:
        return torch.sigmoid(self.albedo)

    def get_roughness(self) -> torch.Tensor:
        return torch.sigmoid(self.roughness)

    def get_metallic(self) -> torch.Tensor:
        return torch.sigmoid(self.metallic)

    def get_covariance(self, scale_modifier: float = 1.0) -> torch.Tensor:
        return math_utils.build_covariance_3d(
            self.get_scaling(), self.rotation, scale_modifier)

    def colors_from_sh(self, campos: torch.Tensor) -> torch.Tensor:
        return sh_ops.sh_to_rgb(self.active_sh_degree, self.features_dc,
                                self.features_rest, self.xyz, campos)

    def one_up_sh_degree(self) -> "GaussianParams":
        if self.active_sh_degree < self.max_sh_degree:
            return dataclasses.replace(
                self, active_sh_degree=self.active_sh_degree + 1)
        return self

    def replace(self, **kw) -> "GaussianParams":
        return dataclasses.replace(self, **kw)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return {k: getattr(self, k).detach().cpu().numpy() for k in FIELDS}


def params_from_numpy(fields: Dict[str, np.ndarray], active_sh_degree: int,
                      max_sh_degree: int, device=None) -> GaussianParams:
    """Weight carry: the field arrays of a JAX `GaussianParams`
    (gaussians.py:33-45, same names) -> the port's parameters on
    `device` (default: the card). Float fields become f32 tensors,
    `alive` a bool tensor."""
    device = resolve_device(device)
    missing = [k for k in FIELDS if k not in fields]
    if missing:
        raise KeyError(f"params_from_numpy: missing fields {missing}")
    t = {}
    for k in FIELDS:
        a = np.asarray(fields[k])
        dtype = torch.bool if k == "alive" else torch.float32
        t[k] = torch.as_tensor(a.astype(bool if k == "alive" else np.float32),
                               dtype=dtype, device=device)
    return GaussianParams(**t, active_sh_degree=int(active_sh_degree),
                          max_sh_degree=int(max_sh_degree))


def create_from_points(points: np.ndarray, colors: np.ndarray,
                       capacity: int, max_sh_degree: int = 3,
                       device=None) -> GaussianParams:
    """Initialise from a point cloud (ref create_from_pcd,
    gaussian_model.py:272-316), on `device` (default: the card): SH DC
    from RGB, higher orders zero; log-scale = log(sqrt(mean squared
    distance to the 3 nearest neighbours)); identity rotation; opacity
    sigmoid^-1(0.1); normal (0, 0, 1); raw albedo/roughness/metallic 1.
    Dead slots: zeros, scaling -10, rotation (1, 0, 0, 0). More points
    than `capacity` are subsampled with RandomState(0), as in JAX."""
    device = resolve_device(device)
    n = points.shape[0]
    if n > capacity:
        print(f"[gi_gs_tpu_torch] init points {n} > capacity {capacity}; "
              f"subsampling", flush=True)
        sel = np.random.RandomState(0).choice(n, capacity, replace=False)
        points = np.asarray(points)[sel]
        colors = np.asarray(colors)[sel]
        n = capacity
    f32 = dict(dtype=torch.float32, device=device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    cols = torch.as_tensor(np.asarray(colors, np.float32), device=device)
    K = (max_sh_degree + 1) ** 2
    dist2 = torch.clamp(mean_knn_dist2(pts), min=1e-7)
    log_scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)

    def pad(x, fill=0.0):
        extra = torch.full((capacity - n,) + tuple(x.shape[1:]), fill, **f32)
        return torch.cat([x, extra], dim=0)

    rot = pad(torch.zeros((n, 4), **f32))
    rot[:, 0] = 1.0
    normal = torch.zeros((n, 3), **f32)
    normal[:, 2] = 1.0
    op0 = math_utils.inverse_sigmoid(0.1).to(device)
    return GaussianParams(
        xyz=pad(pts),
        features_dc=pad(sh_ops.rgb_to_sh0(cols)[:, None, :]),
        features_rest=torch.zeros((capacity, K - 1, 3), **f32),
        opacity=pad(op0.expand(n, 1).clone()),
        normal=pad(normal),
        albedo=pad(torch.ones((n, 3), **f32)),
        roughness=pad(torch.ones((n, 1), **f32)),
        metallic=pad(torch.ones((n, 1), **f32)),
        scaling=pad(log_scales, fill=-10.0),
        rotation=rot,
        alive=torch.arange(capacity, device=device) < n,
        active_sh_degree=0, max_sh_degree=max_sh_degree)


def grow_params(params: GaussianParams, new_capacity: int) -> GaussianParams:
    """Re-pad every field to a larger capacity (data kept, new slots
    dead), with the JAX fills for dead slots (gaussians.py:141-158): raw
    albedo/roughness/metallic 1, normal z 1, scaling -10, rotation w 1."""
    cap = params.capacity
    if new_capacity <= cap:
        return params
    m = new_capacity - cap

    def pad(x, fill=0.0):
        extra = torch.full((m,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                           device=x.device)
        return torch.cat([x, extra], dim=0)

    normal = pad(params.normal)
    normal[cap:, 2] = 1.0
    rotation = pad(params.rotation)
    rotation[cap:, 0] = 1.0
    return params.replace(
        xyz=pad(params.xyz), features_dc=pad(params.features_dc),
        features_rest=pad(params.features_rest),
        opacity=pad(params.opacity), normal=normal,
        albedo=pad(params.albedo, 1.0), roughness=pad(params.roughness, 1.0),
        metallic=pad(params.metallic, 1.0), scaling=pad(params.scaling, -10.0),
        rotation=rotation, alive=pad(params.alive, False))
