"""Screen-space operators (port of gi_gs_tpu/ops/screen_space.py and the
host side of gi_gs_tpu/ops/pallas_gi.py): depth -> normal, SSAO and the
one-bounce SSR indirect diffuse (ref forward.cu:635-1032).

Both SSAO and SSR are one hemisphere ray march per pixel over the view
z-buffer: occ = sum_d w_d * hit_d and dif = sum_d w_d * rgb(hit_d).
`GIParams.backend` selects the march as in JAX (screen_space.py:251-254):
  "pallas"                block-coherent march (`gi_march_coherent`): per
                          (16x128 pixel block, direction, step) every pixel
                          fetches at the block centre's offset, the hit
                          test stays per pixel (pallas_gi._kernel_coherent);
  "pallas_exact", "jnp"   exact march (`gi_march`).
Each march runs its CUDA kernel on CUDA tensors (`csrc/gi_march.cu`,
`csrc/gi_march_coherent.cu`, sharing `csrc/march_walk.cuh`) and its plain
version on CPU tensors; the coherent kernel builds its block-centre offsets
itself, the plain version takes them from `centre_offset_table`. March
semantics (pallas_gi.py:38-46): j in [start, step); an out-of-bounds sample
kills the ray before the depth test; rounding is half away from zero;
+1e-7 on the projected z; a hit (z - thick <= sample <= z + bias)
accumulates and stops the ray. Both read f32 RGB: the TPU kernels' 11-11-10
packing (pallas_gi.py:434-477) was a VMEM workaround.

Gradients as in JAX: SSAO passes none; SSR passes gradient to `albedo`
only, through color = gd.detach() * albedo.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import device_constant
from ..utils.math_utils import rotate_chw
from . import cuda_kernels as ck


class GIParams(NamedTuple):
    """Screen-space GI knobs (train.py:850-855 defaults)."""
    radius: float = 0.8
    bias: float = 0.01
    thick: float = 0.05
    delta: float = 0.0625
    step: int = 16
    start: int = 8
    backend: str = "pallas"


# ---------------------------------------------------------------------------
# depth -> normal + view positions
# ---------------------------------------------------------------------------

def depth_to_normal(depth: torch.Tensor, w2c: torch.Tensor, fx: float,
                    fy: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """depth [H, W] -> (normal_world [3, H, W], depth_pos [3, H, W]),
    replicating depthmapToNormalCUDA: zero on the 1-px border and where
    the 5x5 neighbourhood leaves the image or holds depth < 0.01; the
    normal averages 6 normalised cross products of the 8-neighbour ring,
    rotated to world by the inverse view rotation."""
    H, W = depth.shape
    dev = depth.device
    cx, cy = W / 2.0, H / 2.0
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]

    def position(px, py, d):
        return torch.stack([(px - cx) / fx * d, (py - cy) / fy * d,
                            d.expand(H, W)], dim=0)

    interior1 = (xs > 0) & (xs < W - 1) & (ys > 0) & (ys < H - 1)
    pos = position(xs, ys, depth) * interior1[None]

    valid_depth = (depth >= 0.01).to(torch.float32)
    pad5 = F.pad(valid_depth[None, None], (2, 2, 2, 2), value=0.0)
    window_ok = (-F.max_pool2d(-pad5, 5, stride=1))[0, 0] > 0.5
    ok = interior1 & window_ok & (depth >= 0.01)

    dpad = F.pad(depth[None, None], (1, 1, 1, 1), value=0.0)[0, 0]

    def shifted_pos(dx, dy):
        d = dpad[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
        return position(xs + dx, ys + dy, d)

    p_aa, p_bb = shifted_pos(0, -1), shifted_pos(1, 0)
    p_cc, p_dd = shifted_pos(0, 1), shifted_pos(-1, 0)
    p_ab, p_bc = shifted_pos(1, -1), shifted_pos(1, 1)
    p_cd, p_da = shifted_pos(-1, 1), shifted_pos(-1, -1)

    def cross(u, v):
        return torch.stack([u[1] * v[2] - u[2] * v[1],
                            u[2] * v[0] - u[0] * v[2],
                            u[0] * v[1] - u[1] * v[0]], dim=0)

    def unit(v):
        n = torch.sqrt((v * v).sum(0, keepdim=True))
        return v / torch.clamp(n, min=1e-20)

    e_a, e_b = p_da - p_ab, p_ab - p_bc
    e_c, e_d = p_bc - p_cd, p_cd - p_da
    e_ac, e_bd = p_cc - p_aa, p_dd - p_bb
    e_cdab, e_bcad = p_ab - p_cd, p_da - p_bc

    normal = (unit(cross(e_a, e_d)) + unit(cross(e_d, e_c)) +
              unit(cross(e_c, e_b)) + unit(cross(e_b, e_a)) +
              unit(cross(e_ac, e_bd)) + unit(cross(e_bcad, e_cdab))) / 6.0

    n_world = rotate_chw(w2c[:3, :3].T, normal)
    return n_world * ok[None], pos


# ---------------------------------------------------------------------------
# Ray-march direction table
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def march_directions(delta: float):
    """The CUDA float32 phi/theta accumulation loops, simulated; returns
    numpy (phis [Np], thetas [Nt]) f32."""
    sample_delta = np.float32(delta) * np.float32(math.pi)
    two_pi = np.float32(2.0) * np.float32(math.pi)
    half_pi = np.float32(0.5) * np.float32(math.pi)
    phis = []
    phi = np.float32(0.0)
    while phi < two_pi:
        phis.append(phi)
        phi = np.float32(phi + sample_delta)
    thetas = []
    theta = np.float32(0.0)
    t_step = np.float32(sample_delta * np.float32(0.5))
    while theta <= half_pi:
        thetas.append(theta)
        theta = np.float32(theta + t_step)
    return np.array(phis, np.float32), np.array(thetas, np.float32)


@functools.lru_cache(maxsize=8)
def direction_table(p: GIParams) -> Tuple[np.ndarray, float, int]:
    """[Nd, 4] (dx, dy, dz, w = cos*sin) over the phi x theta grid with
    the zero-weight rows dropped (they add nothing); returns (table,
    sum_w, total direction count including the dropped rows — SSR's
    nrSamples). Port of pallas_gi._direction_table."""
    phis, thetas = march_directions(p.delta)
    rows = []
    total = 0
    for ph in phis:
        for th in thetas:
            total += 1
            w = float(math.cos(th) * math.sin(th))
            if w == 0.0:
                continue
            v = np.array([math.sin(th) * math.cos(ph),
                          math.sin(th) * math.sin(ph),
                          math.cos(th)], np.float32)
            v = v / max(np.linalg.norm(v), 1e-20)
            rows.append([v[0], v[1], v[2], np.float32(w)])
    if not rows:  # degenerate delta: keep one zero-weight row so Nd >= 1
        rows.append([0.0, 0.0, 1.0, 0.0])
    tab = np.asarray(rows, np.float32)
    return tab, float(tab[:, 3].sum()), total


def _direction_rows(p: GIParams) -> np.ndarray:
    return direction_table(p)[0]


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """f32 square root rounded to nearest on every device, as the kernels'
    `sqrtf`: PyTorch's vectorised f32 `sqrt` on the CPU is off by an ulp
    on ~0.7% of inputs (the card's is exact), and one ulp of a normal can
    flip a ray. The f64 root rounded to f32 is the correctly rounded f32
    root (sqrt's double rounding is innocuous)."""
    return torch.sqrt(x.double()).float()


def _unit3(v: torch.Tensor) -> torch.Tensor:
    n = _sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])[None]
    return v / torch.clamp(n, min=1e-20)


def _tbn(normal: torch.Tensor):
    """Gram-Schmidt TBN from the fixed up vector (forward.cu:661-675).
    normal: [3, H, W] unit."""
    up = torch.tensor([0.0, 1.0, 0.0], device=normal.device)[:, None, None]
    tang = _unit3(up - normal * normal[1:2])
    bitan = _unit3(torch.stack([
        normal[1] * tang[2] - normal[2] * tang[1],
        normal[2] * tang[0] - normal[0] * tang[2],
        normal[0] * tang[1] - normal[1] * tang[0]], dim=0))
    return tang, bitan, normal


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    return torch.trunc(x + torch.where(x >= 0, 0.5, -0.5))


def _z_scale(z: torch.Tensor, p: GIParams) -> torch.Tensor:
    """(1 + z / 100)^2 * radius / step, with z / 100 an f32 division on
    both devices as the kernels compute it: PyTorch divides a CUDA tensor
    by a Python number as a multiplication by its reciprocal, which moves
    a sample by an ulp now and then and flips its ray."""
    return (1.0 + z / torch.full_like(z, 100.0)) ** 2 * (p.radius / p.step)


def _march_plain(pos, sample_vec, value_img, depth_img, fx, fy,
                 p: GIParams, work: Optional[dict] = None):
    """Port of the jnp oracle `_march` (screen_space.py:171-212) for one
    direction batch. pos [3, H, W]; sample_vec [B, 3, H, W]; value_img
    [C, H, W] or None; depth_img [H, W]. Returns hit [B, H, W] and the
    value at the hit [B, C, H, W] (zeros without a hit or value_img)."""
    H, W = depth_img.shape
    dev = pos.device
    cx, cy = W / 2.0, H / 2.0
    z_scale = _z_scale(pos[2], p)
    B = sample_vec.shape[0]
    C = 0 if value_img is None else value_img.shape[0]
    hit = torch.zeros((B, H, W), dtype=torch.bool, device=dev)
    dead = torch.zeros((B, H, W), dtype=torch.bool, device=dev)
    val = torch.zeros((B, max(C, 1), H, W), dtype=torch.float32, device=dev)
    flat_depth = depth_img.reshape(-1)
    flat_val = None if value_img is None else value_img.reshape(C, -1)
    for j in range(p.start, p.step):
        if work is not None:
            work["samples"] = work.get("samples", 0) + int((~dead).sum())
        sp = pos[None] + sample_vec * (j * z_scale)[None, None]
        zz = sp[:, 2] + 1e-7
        ix = _round_half_away(sp[:, 0] / zz * fx + cx)
        iy = _round_half_away(sp[:, 1] / zz * fy + cy)
        oob = (ix < 0) | (ix > W - 1) | (iy < 0) | (iy > H - 1)
        lin = (torch.clamp(iy, 0, H - 1) * W + torch.clamp(ix, 0, W - 1)
               ).to(torch.int64)
        sample_depth = flat_depth[lin]
        is_hit = ((sample_depth <= sp[:, 2] + p.bias) &
                  (sample_depth >= sp[:, 2] - p.thick))
        new_dead = dead | oob
        new_hit = ~new_dead & ~hit & is_hit
        if flat_val is not None:
            gathered = flat_val[:, lin.reshape(-1)].reshape(C, B, H, W)
            val = val + torch.where(new_hit[:, None],
                                    gathered.permute(1, 0, 2, 3), 0.0)
        hit = hit | new_hit
        dead = new_dead | hit
    return hit, val


def _gi_march_plain(normal_view, pos, rgb, fx, fy, p: GIParams,
                    batch: int = 16, work: Optional[dict] = None):
    """Plain version of `gi_march`: the direction table in batches through
    `_march_plain`, as the jnp ssao/ssr scan bodies do."""
    H, W = pos.shape[1:]
    dev = pos.device
    nrm = _unit3(normal_view)
    tang, bitan, nrm3 = _tbn(nrm)
    tab = device_constant(_direction_rows, p, device=dev)
    occ = torch.zeros((H, W), dtype=torch.float32, device=dev)
    dif = torch.zeros((3, H, W), dtype=torch.float32, device=dev)
    for s in range(0, tab.shape[0], batch):
        d, w = tab[s:s + batch, :3], tab[s:s + batch, 3]
        sv = (d[:, 0, None, None, None] * tang[None] +
              d[:, 1, None, None, None] * bitan[None] +
              d[:, 2, None, None, None] * nrm3[None])
        hit, val = _march_plain(pos, sv, rgb, pos[2], fx, fy, p, work)
        occ = occ + (hit * w[:, None, None]).sum(0)
        if rgb is not None:
            dif = dif + (val * w[:, None, None, None]).sum(0)
    return occ, dif


def gi_march(normal_view: torch.Tensor, pos: torch.Tensor,
             rgb: Optional[torch.Tensor], fx: float, fy: float,
             p: GIParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hemisphere march of every pixel (replaces
    pallas_gi._march_pallas(mode="exact")). normal_view, pos [3, H, W];
    rgb [3, H, W] (SSR) or None (SSAO). Returns occ [H, W] and dif
    [3, H, W] (zeros without rgb)."""
    if not pos.is_cuda:
        return _gi_march_plain(normal_view, pos, rgb, fx, fy, p)
    dev = pos.device
    H, W = pos.shape[1:]
    tab = device_constant(_direction_rows, p, device=dev)
    normal_view = normal_view.contiguous()
    pos = pos.contiguous()
    ck.check(normal_view, "normal_view", torch.float32, (3, H, W), dev)
    ck.check(pos, "pos", torch.float32, (3, H, W), dev)
    if rgb is not None:
        rgb = rgb.contiguous()
        ck.check(rgb, "rgb", torch.float32, (3, H, W), dev)
    occ = torch.empty((H, W), dtype=torch.float32, device=dev)
    dif = (torch.empty((3, H, W), dtype=torch.float32, device=dev)
           if rgb is not None else torch.zeros((3, H, W), device=dev))
    ck.launch("gi_march", dev,
              normal_view.data_ptr(), pos.data_ptr(),
              rgb.data_ptr() if rgb is not None else None, tab.data_ptr(),
              tab.shape[0], H, W, float(np.float32(fx)),
              float(np.float32(fy)), W / 2.0, H / 2.0,
              float(np.float32(p.radius / p.step)), p.bias, p.thick,
              p.start, p.step, occ.data_ptr(),
              dif.data_ptr() if rgb is not None else None)
    return occ, dif


# ---------------------------------------------------------------------------
# The block-coherent march (GIParams.backend "pallas")
# ---------------------------------------------------------------------------

BH, BW = 16, 128   # pixel block of the coherent march (pallas_gi.py:62-65)
_KOFF = 2048       # offset bias of the packed keys (pallas_gi.py:69)


def centre_offset_table(normal_view: torch.Tensor, pos: torch.Tensor,
                        dirs: torch.Tensor, fx: float, fy: float,
                        p: GIParams) -> torch.Tensor:
    """The block-centre fetch offsets of the coherent march (port of
    pallas_gi._centre_offset_table, same f32 operations in the same order):
    int32 [nby, nbx, nd, nsteps], key = (dy + K) * 2K + (dx + K), K = 2048.
    The centres are taken in the G-buffer zero-padded to (16, 128)
    multiples, as on the TPU: a block whose centre lies in the padding
    (the last column block when W is not a multiple of 128) gets the
    offsets of a zero normal at the origin, whatever its real pixels
    hold. The centre's z / 100 is z * f32(0.01), as XLA computes it and
    as PyTorch divides by a Python number on the card, so the CPU and the
    card give the same keys. With start >= step the march takes no step:
    the table is JAX's unread zero table [nby, nbx, nd, 1]."""
    h, w = pos.shape[1:]
    nby, nbx = -(-h // BH), -(-w // BW)
    dev = pos.device
    if p.start >= p.step:
        return torch.zeros((nby, nbx, dirs.shape[0], 1), dtype=torch.int32,
                           device=dev)
    ci, cj = BH // 2, BW // 2
    pad = (0, nbx * BW - w, 0, nby * BH - h)
    nc = F.pad(normal_view, pad)[:, ci::BH, cj::BW]       # [3, nby, nbx]
    pc = F.pad(pos, pad)[:, ci::BH, cj::BW]
    fx, fy = float(np.float32(fx)), float(np.float32(fy))
    cx, cy = w / 2.0, h / 2.0

    def unit3(x, y, z):
        n = torch.clamp(_sqrt(x * x + y * y + z * z), min=1e-20)
        return x / n, y / n, z / n

    ncx, ncy, ncz = unit3(nc[0], nc[1], nc[2])
    tcx, tcy, tcz = unit3(-ncx * ncy, 1.0 - ncy * ncy, -ncz * ncy)
    bcx, bcy, bcz = unit3(ncy * tcz - ncz * tcy, ncz * tcx - ncx * tcz,
                          ncx * tcy - ncy * tcx)
    zsc_c = (1.0 + pc[2] * 0.01) ** 2 * (p.radius / p.step)
    px_c = (torch.arange(nbx, dtype=torch.float32, device=dev) * BW + cj
            )[None, :, None]
    py_c = (torch.arange(nby, dtype=torch.float32, device=dev) * BH + ci
            )[:, None, None]
    e = lambda a: a[None, None, :]          # [1, 1, nd]
    b = lambda a: a[:, :, None]             # [nby, nbx, 1]
    scx = e(dirs[:, 0]) * b(tcx) + e(dirs[:, 1]) * b(bcx) + e(dirs[:, 2]) * b(ncx)
    scy = e(dirs[:, 0]) * b(tcy) + e(dirs[:, 1]) * b(bcy) + e(dirs[:, 2]) * b(ncy)
    scz = e(dirs[:, 0]) * b(tcz) + e(dirs[:, 1]) * b(bcz) + e(dirs[:, 2]) * b(ncz)
    keys = []
    for j in range(p.start, p.step):
        tc = float(j) * b(zsc_c)
        spx = b(pc[0]) + scx * tc
        spy = b(pc[1]) + scy * tc
        spz = b(pc[2]) + scz * tc
        zz = spz + 1e-7
        dxc = _round_half_away(spx / zz * fx + cx) - px_c
        dyc = _round_half_away(spy / zz * fy + cy) - py_c
        dxi = torch.clamp(dxc, -_KOFF + 1, _KOFF - 1).to(torch.int32)
        dyi = torch.clamp(dyc, -_KOFF + 1, _KOFF - 1).to(torch.int32)
        keys.append((dyi + _KOFF) * (2 * _KOFF) + (dxi + _KOFF))
    return torch.stack(keys, dim=-1).contiguous()


def _gi_march_coherent_plain(normal_view, pos, rgb, keys, p: GIParams,
                             batch: int = 16, work: Optional[dict] = None):
    """Plain version of `gi_march_coherent`, per pixel as
    pallas_gi._kernel_coherent: the pixel's own normal gives the z row of
    its TBN and its marched depth spz = posz + svz * (j * zsc); the sample
    sits at pixel + its block's centre offset (out of bounds kills the ray
    before the depth test); z and RGB are read there. Directions run in
    batches."""
    H, W = pos.shape[1:]
    dev = pos.device
    nrm = _unit3(normal_view)
    tang, bitan, nrm3 = _tbn(nrm)
    tab = device_constant(_direction_rows, p, device=dev)
    posz = pos[2]
    zsc = _z_scale(posz, p)
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    flat_z = posz.reshape(-1)
    flat_rgb = None if rgb is None else rgb.reshape(3, -1)
    occ = torch.zeros((H, W), dtype=torch.float32, device=dev)
    dif = torch.zeros((3, H, W), dtype=torch.float32, device=dev)
    for s in range(0, tab.shape[0], batch):
        d, w = tab[s:s + batch, :3], tab[s:s + batch, 3]
        B = d.shape[0]
        svz = (d[:, 0, None, None] * tang[2] + d[:, 1, None, None] * bitan[2]
               + d[:, 2, None, None] * nrm3[2])
        hit = torch.zeros((B, H, W), dtype=torch.bool, device=dev)
        dead = torch.zeros((B, H, W), dtype=torch.bool, device=dev)
        val = torch.zeros((B, 3, H, W), dtype=torch.float32, device=dev)
        for j in range(p.start, p.step):
            if work is not None:
                work["samples"] = work.get("samples", 0) + int((~dead).sum())
            k = keys[:, :, s:s + B, j - p.start].permute(2, 0, 1)
            k = k.repeat_interleave(BH, 1).repeat_interleave(BW, 2)[:, :H, :W]
            iy = ys + (k // (2 * _KOFF) - _KOFF)
            ix = xs + (k % (2 * _KOFF) - _KOFF)
            oob = (ix < 0) | (ix > W - 1) | (iy < 0) | (iy > H - 1)
            lin = (torch.clamp(iy, 0, H - 1) * W + torch.clamp(ix, 0, W - 1)
                   ).to(torch.int64)
            spz = posz + svz * (float(j) * zsc)
            sample = flat_z[lin]
            is_hit = (sample <= spz + p.bias) & (sample >= spz - p.thick)
            new_dead = dead | oob
            new_hit = ~new_dead & ~hit & is_hit
            if flat_rgb is not None:
                g = flat_rgb[:, lin.reshape(-1)].reshape(3, B, H, W)
                val = val + torch.where(new_hit[:, None],
                                        g.permute(1, 0, 2, 3), 0.0)
            hit = hit | new_hit
            dead = new_dead | hit
        occ = occ + (hit * w[:, None, None]).sum(0)
        if rgb is not None:
            dif = dif + (val * w[:, None, None, None]).sum(0)
    return occ, dif


def gi_march_coherent(normal_view: torch.Tensor, pos: torch.Tensor,
                      rgb: Optional[torch.Tensor], fx: float, fy: float,
                      p: GIParams, keys_out: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-coherent hemisphere march of every pixel (replaces
    pallas_gi._march_pallas(mode="coherent")). Same arguments and outputs
    as `gi_march`. On CUDA tensors one kernel launch builds the
    block-centre offsets and marches; `keys_out` (int32, the shape of
    `centre_offset_table`'s result), if given, receives the keys it built.
    On CPU tensors the plain versions run."""
    dev = pos.device
    tab = device_constant(_direction_rows, p, device=dev)
    if not pos.is_cuda:
        keys = centre_offset_table(normal_view, pos, tab, fx, fy, p)
        if keys_out is not None:
            keys_out.copy_(keys)
        return _gi_march_coherent_plain(normal_view, pos, rgb, keys, p)
    H, W = pos.shape[1:]
    normal_view = normal_view.contiguous()
    pos = pos.contiguous()
    ck.check(normal_view, "normal_view", torch.float32, (3, H, W), dev)
    ck.check(pos, "pos", torch.float32, (3, H, W), dev)
    if rgb is not None:
        rgb = rgb.contiguous()
        ck.check(rgb, "rgb", torch.float32, (3, H, W), dev)
    if keys_out is not None:
        ck.check(keys_out, "keys_out", torch.int32,
                 (-(-H // BH), -(-W // BW), tab.shape[0],
                  max(p.step - p.start, 1)), dev)
        if p.start >= p.step:
            keys_out.zero_()
    occ = torch.empty((H, W), dtype=torch.float32, device=dev)
    dif = (torch.empty((3, H, W), dtype=torch.float32, device=dev)
           if rgb is not None else torch.zeros((3, H, W), device=dev))
    ck.launch("gi_march_coherent", dev,
              normal_view.data_ptr(), pos.data_ptr(),
              rgb.data_ptr() if rgb is not None else None, tab.data_ptr(),
              tab.shape[0], H, W, float(np.float32(fx)),
              float(np.float32(fy)), W / 2.0, H / 2.0,
              float(np.float32(p.radius / p.step)), p.bias, p.thick,
              p.start, p.step, occ.data_ptr(),
              dif.data_ptr() if rgb is not None else None,
              keys_out.data_ptr() if keys_out is not None else None)
    return occ, dif


def kernel_resources(kernel: str, p: GIParams, device: torch.device,
                     with_rgb: bool = True) -> dict:
    """Registers, shared memory and resident blocks per SM of the march
    kernel `kernel` ("gi_march" or "gi_march_coherent"; the SSR
    instantiation unless `with_rgb` is False) at p's direction table
    (`cuda_kernels.resources`; the coherent kernel also reports its
    cluster size and the clusters the card holds at once)."""
    nd = direction_table(p)[0].shape[0]
    if kernel == "gi_march_coherent":
        return ck.resources("gigs_gi_march_coherent_resources", device,
                            int(with_rgb), nd, max(p.step - p.start, 0))
    return ck.resources("gigs_gi_march_resources", device, int(with_rgb), nd)


def march(normal_view, pos, rgb, fx, fy, p: GIParams):
    """The march `p.backend` selects, as JAX dispatches it
    (screen_space.py:251-254): "pallas" (and any other "pallas*" but
    "pallas_exact") is the coherent march, the rest the exact one."""
    if p.backend.startswith("pallas") and p.backend != "pallas_exact":
        return gi_march_coherent(normal_view, pos, rgb, fx, fy, p)
    return gi_march(normal_view, pos, rgb, fx, fy, p)


def ssao(normal_view: torch.Tensor, pos: torch.Tensor, fx: float, fy: float,
         p: GIParams) -> torch.Tensor:
    """Screen-space ambient occlusion [1, H, W] (SSAOCUDA; host math of
    pallas_gi.ssao_pallas). No gradient, as in the reference."""
    occ, _ = march(normal_view.detach(), pos.detach(), None, fx, fy, p)
    _, sum_w, _ = direction_table(p)
    if sum_w > 0:
        out = torch.clamp(1.0 - occ / sum_w, 0.0, 1.0)
    else:
        out = torch.ones_like(occ)
    return out[None]


def fresnel_schlick(cos_theta, f0):
    """ssr.h:13-16."""
    return f0 + (1.0 - f0) * torch.pow(
        torch.clamp(1.0 - cos_theta, 1e-6, 1.0), 5.0)


def ssr(normal_view: torch.Tensor, pos: torch.Tensor, rgb: torch.Tensor,
        albedo: torch.Tensor, roughness: torch.Tensor, metallic: torch.Tensor,
        f0: torch.Tensor, fx: float, fy: float, p: GIParams
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-bounce screen-space indirect diffuse (SSRCUDA; host math of
    pallas_gi.ssr_pallas). Returns (color, gd), both [3, H, W], with
    color = gd.detach() * albedo: the only gradient is d(color)/d(albedo)
    = gd (diff_gaussian_rasterization/__init__.py:666-673)."""
    normal_view, pos, rgb = normal_view.detach(), pos.detach(), rgb.detach()
    f0, metallic = f0.detach(), metallic.detach()
    nrm = _unit3(normal_view)
    v_dir = _unit3(-pos)
    n_dot_v = torch.clamp((nrm * v_dir).sum(0, keepdim=True), min=1e-7)
    fr = fresnel_schlick(n_dot_v, f0)
    k_d = (1.0 - fr) * (1.0 - metallic)
    _, dif = march(normal_view, pos, rgb, fx, fy, p)
    _, _, n_total = direction_table(p)
    if n_total > 0:
        gd = math.pi * dif / n_total * k_d
        color = gd * albedo
    else:
        gd = torch.full_like(albedo, 1e-7)
        color = gd + 0.0 * albedo
    return color, gd
