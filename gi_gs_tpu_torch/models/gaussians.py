"""Capacity-padded Gaussian parameters (port of
gi_gs_tpu/models/gaussians.py): raw pre-activation tensors of a fixed
capacity with an `alive` mask, and the activations the renderer reads.

Raw layout (ref gaussian_model.py:59-80): xyz [C,3], features_dc [C,1,3],
features_rest [C,K-1,3], opacity [C,1] (sigmoid), normal [C,3] (L2),
albedo [C,3], roughness [C,1], metallic [C,1] (sigmoid), scaling [C,3]
(exp), rotation [C,4] (normalised quat, w-first), alive [C] bool.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..ops import sh as sh_ops
from ..utils import math_utils
from ..utils.device import resolve_device

FIELDS = ("xyz", "features_dc", "features_rest", "opacity", "normal",
          "albedo", "roughness", "metallic", "scaling", "rotation", "alive")


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

    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    def get_opacity(self) -> torch.Tensor:
        # Dead (padding) slots must not render: force opacity to 0.
        return torch.sigmoid(self.opacity) * self.alive[:, None]

    def get_features(self) -> torch.Tensor:
        return torch.cat([self.features_dc, self.features_rest], dim=1)

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
        return sh_ops.sh_to_rgb(self.active_sh_degree, self.get_features(),
                                self.xyz, campos)

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
