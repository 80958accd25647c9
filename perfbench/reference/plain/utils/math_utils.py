"""Core math helpers (port of gi_gs_tpu/utils/math_utils.py):
quaternions, normalisation, the quaternion-built 3D covariance,
activations, the learning-rate schedule, camera matrices (numpy, host
side), colour transforms."""
from __future__ import annotations

import math

import numpy as np
import torch

_F32_EPS = float(np.finfo(np.float32).eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) -> [..., 3, 3] rotation matrix of the
    un-normalised quaternion (computeCov3D, forward.cu:127-147)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r0 = torch.stack([1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z),
                      2.0 * (x * z + w * y)], dim=-1)
    r1 = torch.stack([2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z),
                      2.0 * (y * z - w * x)], dim=-1)
    r2 = torch.stack([2.0 * (x * z - w * y), 2.0 * (y * z + w * x),
                      1.0 - 2.0 * (x * x + y * y)], dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12
              ) -> torch.Tensor:
    """v * rsqrt(max(|v|^2, eps^2)) — finite at v == 0 (capacity-padded
    dead Gaussians hold zero vectors)."""
    n2 = (v * v).sum(dim=dim, keepdim=True)
    return v * torch.rsqrt(torch.maximum(n2, torch.full_like(n2, eps * eps)))


def rotate_chw(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M [3, 3] applied to every pixel of v [3, H, W]:
    (M[i, 0] v0 + M[i, 1] v1) + M[i, 2] v2, one elementwise op at a time,
    so the CPU and the card round every step alike; a BLAS product
    (einsum) rounds as its library's kernel goes (fused multiply-adds,
    blocking) and so differs between the devices."""
    return torch.stack([M[i, 0] * v[0] + M[i, 1] * v[1] + M[i, 2] * v[2]
                        for i in range(3)])


def build_covariance_3d(scaling: torch.Tensor, rotation_raw: torch.Tensor,
                        scale_modifier: float = 1.0) -> torch.Tensor:
    """Upper-triangular (xx, xy, xz, yy, yz, zz) of R diag(s^2) R^T with R
    from the raw quaternion (computeCov3D, forward.cu:127-161)."""
    w, x, y, z = (rotation_raw[..., 0], rotation_raw[..., 1],
                  rotation_raw[..., 2], rotation_raw[..., 3])
    sx = scaling[..., 0] * scale_modifier
    sy = scaling[..., 1] * scale_modifier
    sz = scaling[..., 2] * scale_modifier
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    m00, m01, m02 = r00 * sx, r01 * sy, r02 * sz
    m10, m11, m12 = r10 * sx, r11 * sy, r12 * sz
    m20, m21, m22 = r20 * sx, r21 * sy, r22 * sz
    return torch.stack([
        m00 * m00 + m01 * m01 + m02 * m02,
        m00 * m10 + m01 * m11 + m02 * m12,
        m00 * m20 + m01 * m21 + m02 * m22,
        m10 * m10 + m11 * m11 + m12 * m12,
        m10 * m20 + m11 * m21 + m12 * m22,
        m20 * m20 + m21 * m21 + m22 * m22,
    ], dim=-1)


# ---------------------------------------------------------------------------
# Activations and the learning-rate schedule
# ---------------------------------------------------------------------------

def inverse_sigmoid(x):
    """log(x / (1 - x)). A python number is divided in double precision
    and the log taken in f32, as `jnp.log` does with a python quotient."""
    if torch.is_tensor(x):
        return torch.log(x / (1.0 - x))
    return torch.log(torch.tensor(x / (1.0 - x), dtype=torch.float32))


def expon_lr(step, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
             max_steps=1_000_000) -> float:
    """Log-linear interpolated learning rate with optional delayed warm-up
    (get_expon_lr_func), evaluated in f32 like the JAX version; 0 for
    step < 0. Returns the f32 value as a python float."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    step = f32(step)
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    log_lerp = torch.exp(torch.log(f32(lr_init)) * (1 - t)
                         + torch.log(f32(lr_final)) * t)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0))
    else:
        delay_rate = 1.0
    lr = delay_rate * log_lerp
    return 0.0 if float(step) < 0 else float(lr)


# ---------------------------------------------------------------------------
# Camera matrices (numpy, host side — ref utils/graphics_utils.py)
# ---------------------------------------------------------------------------

def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate: np.ndarray | None = None,
                  scale: float = 1.0) -> np.ndarray:
    """W2C matrix, `getWorld2View2` (utils/graphics_utils.py:42-58)."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    cam_center = C2W[:3, 3]
    if translate is not None:
        cam_center = (cam_center + translate) * scale
    C2W[:3, 3] = cam_center
    return np.linalg.inv(C2W).astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float
                      ) -> np.ndarray:
    """`getProjectionMatrix` (utils/graphics_utils.py:62-82)."""
    tan_x = math.tan(fovx / 2)
    tan_y = math.tan(fovy / 2)
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / tan_x
    P[1, 1] = 1.0 / tan_y
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


# ---------------------------------------------------------------------------
# Colour transforms (ref train.py:54-81, pbr/shade.py:32-43)
# ---------------------------------------------------------------------------

def clip(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """jnp.clip: min(max(x, lo), hi). At a tie the gradient splits in half
    like jnp.maximum/minimum; torch.clamp passes it whole. `lo`/`hi` are
    numbers or tensors."""
    if lo is not None:
        x = torch.maximum(x, lo if torch.is_tensor(lo) else x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, hi if torch.is_tensor(hi) else x.new_full((), hi))
    return x


def linear_to_srgb(linear: torch.Tensor) -> torch.Tensor:
    """Mip-NeRF-style linear->sRGB (ref train.py:54-68)."""
    srgb0 = 323.0 / 25.0 * linear
    srgb1 = (211.0 * clip(linear, _F32_EPS) ** (5.0 / 12.0) - 11.0) / 200.0
    return torch.where(linear <= 0.0031308, srgb0, srgb1)


def srgb_to_linear(srgb: torch.Tensor) -> torch.Tensor:
    """Inverse of linear_to_srgb (ref train.py:70-81)."""
    linear0 = 25.0 / 323.0 * srgb
    linear1 = ((srgb + 0.055) / 1.055) ** 2.4
    return torch.where(srgb <= 0.04045, linear0, linear1)


def aces_film(rgb: torch.Tensor) -> torch.Tensor:
    """ACES filmic tonemap clamped to [0, 1] (ref pbr/shade.py:32-43)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    out = (rgb * (a * rgb + b)) / (rgb * (c * rgb + d) + e)
    return clip(out, 0.0, 1.0)
