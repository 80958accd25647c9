"""Camera model (port of gi_gs_tpu/scene/cameras.py): plain row-major
maths, `p_cam = w2c @ [p, 1]`, `clip = full_proj @ [p, 1]`.

Matrices are f32 tensors on the camera's device; the scalars are python
floats holding the same f32 values the JAX camera carries."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..utils import math_utils, timing
from ..utils.device import resolve_device


def _f32(v: float) -> float:
    return float(np.float32(v))


@dataclasses.dataclass
class Camera:
    w2c: torch.Tensor        # [4, 4] world -> view
    full_proj: torch.Tensor  # [4, 4] proj @ w2c (world -> clip)
    cam_pos: torch.Tensor    # [3] camera centre in world space
    tanfovx: float
    tanfovy: float
    fx: float
    fy: float
    width: int
    height: int

    @property
    def device(self) -> torch.device:
        return self.w2c.device


def make_camera(R: np.ndarray, T: np.ndarray, fovx: float, fovy: float,
                width: int, height: int, znear: float = 0.01,
                zfar: float = 100.0, trans: Optional[np.ndarray] = None,
                scale: float = 1.0, device=None) -> Camera:
    """Camera from COLMAP-convention R (cam-to-world rotation) and T
    (world-to-cam translation), ref Camera.__init__ (scene/cameras.py),
    on `device` (default: the card)."""
    device = resolve_device(device)
    w2c = math_utils.world_to_view(R, T, translate=trans, scale=scale)
    proj = math_utils.projection_matrix(znear, zfar, fovx, fovy)
    full_proj = (proj @ w2c).astype(np.float32)
    cam_pos = np.linalg.inv(w2c)[:3, 3].astype(np.float32)
    tanfovx = math.tan(fovx * 0.5)
    tanfovy = math.tan(fovy * 0.5)
    fx = width / (2.0 * tanfovx)
    fy = height / (2.0 * tanfovy)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return Camera(w2c=t(w2c), full_proj=t(full_proj), cam_pos=t(cam_pos),
                  tanfovx=_f32(tanfovx), tanfovy=_f32(tanfovy),
                  fx=_f32(fx), fy=_f32(fy), width=int(width),
                  height=int(height))


def camera_to_json(idx: int, record) -> dict:
    """SIBR-compatible cameras.json entry (ref camera_to_JSON,
    utils/camera_utils.py:89-109); `record` is a dataset CameraRecord."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = record.R.transpose()
    Rt[:3, 3] = record.T
    Rt[3, 3] = 1.0
    W2C = np.linalg.inv(Rt)
    return {
        "id": idx,
        "img_name": record.name,
        "width": record.width,
        "height": record.height,
        "position": W2C[:3, 3].tolist(),
        "rotation": [r.tolist() for r in W2C[:3, :3]],
        "fy": math_utils.fov2focal(record.fovy, record.height),
        "fx": math_utils.fov2focal(record.fovx, record.width),
    }


def canonical_rays(camera: Camera) -> torch.Tensor:
    """Per-pixel camera-space rays (x/fx, y/fy, 1) at pixel centres,
    flattened to [H*W, 3] (ref Scene.get_canonical_rays)."""
    H, W = camera.height, camera.width
    dev = camera.device
    u = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    v = torch.arange(H, dtype=torch.float32, device=dev) + 0.5
    vv, uu = torch.meshgrid(v, u, indexing="ij")  # [H, W]
    x = (uu - W * 0.5) / camera.fx
    y = (vv - H * 0.5) / camera.fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1).reshape(-1, 3)


def compute_view_dirs(camera: Camera) -> torch.Tensor:
    """[3, H, W] outward view directions from the canonical rays
    (gi_gs_tpu/train/trainer.py compute_view_dirs; ref train.py:303-307)."""
    rays = canonical_rays(camera)
    rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
    with timing.span("sync.view_dirs_inv"):     # inv reads its info flag
        c2w = torch.linalg.inv(camera.w2c)
    vd = -(rays @ c2w[:3, :3].T)
    return vd.T.reshape(3, camera.height, camera.width)
