"""Densification on capacity-padded parameters (port of
gi_gs_tpu/train/densify.py; ref densify_and_prune + clone/split/prune,
scene/gaussian_model.py:595-945): clones and splits are written into dead
capacity slots and pruning clears `alive` bits.

Semantics of the fork (AbsGS-style dual threshold): ratio = share of live
points with ||grad|| >= threshold, Q = the (1 - ratio) quantile of the
abs-grad statistic over live points; clone and split both sample new
positions from the Gaussian itself; a split divides the activated scale
by 1.6; the statistics restart after densification.

The clone/split position noise [cap, 3] is an argument: the trainer draws
it from its `torch.Generator`, and a test can feed JAX's draw.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.gaussians import GaussianParams
from ..utils import math_utils


@dataclasses.dataclass
class DensifyStats:
    accum: torch.Tensor          # [C, 1] sum ||ndc grad xy||
    accum_abs: torch.Tensor      # [C, 1] sum (|gx| + |gy|)
    accum_abs_max: torch.Tensor  # [C, 1] running max of (|gx| + |gy|)
    denom: torch.Tensor          # [C, 1]
    max_radii2d: torch.Tensor    # [C]

    FIELDS = ("accum", "accum_abs", "accum_abs_max", "denom", "max_radii2d")

    @staticmethod
    def zeros(capacity: int, device) -> "DensifyStats":
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
        return DensifyStats(z(capacity, 1), z(capacity, 1), z(capacity, 1),
                            z(capacity, 1), z(capacity))


def update_stats(stats: DensifyStats, ndc_grad: torch.Tensor,
                 visibility: torch.Tensor, radii: torch.Tensor
                 ) -> DensifyStats:
    """Per-iteration accumulation (ref add_densification_stats,
    gaussian_model.py:933-945, and the max_radii2D update,
    train.py:495-497)."""
    vis = visibility[:, None].to(torch.float32)
    g = ndc_grad[:, :2]
    norm_g = torch.linalg.norm(g, dim=-1, keepdim=True)
    abs_g = g[:, :1].abs() + g[:, 1:2].abs()
    return DensifyStats(
        accum=stats.accum + vis * norm_g,
        accum_abs=stats.accum_abs + vis * abs_g,
        accum_abs_max=torch.maximum(
            stats.accum_abs_max,
            torch.where(vis > 0, abs_g, stats.accum_abs_max)),
        denom=stats.denom + vis,
        max_radii2d=torch.where(
            visibility, torch.maximum(stats.max_radii2d,
                                      radii.to(torch.float32)),
            stats.max_radii2d))


def _padded_nonzero(mask: torch.Tensor, size: int) -> torch.Tensor:
    """jnp.nonzero(mask, size=size, fill_value=size): the True indices in
    order, then `size`."""
    idx = torch.nonzero(mask).reshape(-1)
    out = torch.full((size,), size, dtype=torch.int64, device=mask.device)
    out[:idx.shape[0]] = idx
    return out


@torch.no_grad()
def densify_and_prune(noise: torch.Tensor, params: GaussianParams,
                      stats: DensifyStats, max_grad: float,
                      min_opacity: float, extent: float,
                      max_screen_size: Optional[float], percent_dense: float):
    """-> (params', fresh stats, new_slot_mask [C], n_dropped [] int64).

    new_slot_mask marks the slots whose optimizer moments must be zeroed
    (optim.surgery_new_slots). n_dropped > 0 means the schedule wanted
    more slots than the capacity holds (the CLI's growth trigger)."""
    cap = params.capacity
    dev = params.device
    alive = params.alive

    grads = stats.accum / stats.denom
    grads = torch.where(torch.isnan(grads), 0.0, grads)[:, 0]
    grads_abs = stats.accum_abs / stats.denom
    grads_abs = torch.where(torch.isnan(grads_abs), 0.0, grads_abs)[:, 0]

    n_alive = torch.clamp(alive.to(torch.float32).sum(), min=1.0)
    ratio = ((grads >= max_grad) & alive).sum() / n_alive
    q_thresh = torch.nanquantile(
        torch.where(alive, grads_abs, float("nan")), 1.0 - ratio)

    grad_sel = ((grads >= max_grad) | (grads_abs >= q_thresh)) & alive
    scaling = params.get_scaling()
    max_scale = scaling.max(dim=1).values
    clone_mask = grad_sel & (max_scale <= percent_dense * extent)
    split_mask = grad_sel & (max_scale > percent_dense * extent)
    n_clone = clone_mask.sum()
    n_split = split_mask.sum()

    clone_src = _padded_nonzero(clone_mask, cap)
    split_src = _padded_nonzero(split_mask, cap)
    free_slots = _padded_nonzero(~alive, cap)
    n_free = (~alive).sum()

    # New-item table: k < n_clone -> a clone of clone_src[k]; then two
    # split replicas per split source.
    k = torch.arange(cap, dtype=torch.int64, device=dev)
    is_clone = k < n_clone
    split_item = k - n_clone
    is_split = (split_item >= 0) & (split_item < 2 * n_split)
    src = torch.where(is_clone, clone_src[torch.clamp(k, max=cap - 1)],
                      split_src[torch.clamp(split_item // 2, 0, cap - 1)])
    # A split consumes its source only if both replicas found a free slot.
    split_fits = (n_clone + 2 * (split_item // 2) + 1) < n_free
    valid = ((is_clone & (k < n_free)) | (is_split & split_fits)) & (src < cap)
    n_dropped = torch.clamp(n_clone + 2 * n_split - n_free, min=0)
    split_done = torch.zeros(cap, dtype=torch.bool, device=dev)
    sdone = (k < n_split) & ((n_clone + 2 * k + 1) < n_free)
    keep = split_src < cap
    split_done[split_src[keep]] = sdone[keep]
    src_safe = torch.clamp(src, max=cap - 1)
    target = torch.where(valid, free_slots[torch.clamp(k, max=cap - 1)],
                         torch.full_like(k, cap))

    # Sampled positions: rot(q_src) @ (noise * scale_src) + xyz_src for
    # clones and splits (gaussian_model.py:721-725,760-765).
    stds = scaling[src_safe]
    rots = math_utils.quat_to_rotmat(params.get_rotation()[src_safe])
    new_xyz = torch.einsum("nij,nj->ni", rots, noise * stds) + \
        params.xyz[src_safe]
    # Scaling: clones copy the raw value; splits get log(scale / 1.6).
    new_scaling = torch.where(is_clone[:, None], params.scaling[src_safe],
                              torch.log(scaling[src_safe] / (0.8 * 2)))

    placed = target < cap
    tgt = target[placed]

    def place(leaf, new_vals):
        leaf = leaf.clone()
        leaf[tgt] = new_vals[placed]
        return leaf

    new_params = params.replace(
        xyz=place(params.xyz, new_xyz),
        features_dc=place(params.features_dc, params.features_dc[src_safe]),
        features_rest=place(params.features_rest,
                            params.features_rest[src_safe]),
        opacity=place(params.opacity, params.opacity[src_safe]),
        normal=place(params.normal, params.normal[src_safe]),
        albedo=place(params.albedo, params.albedo[src_safe]),
        roughness=place(params.roughness, params.roughness[src_safe]),
        metallic=place(params.metallic, params.metallic[src_safe]),
        scaling=place(params.scaling, new_scaling),
        rotation=place(params.rotation, params.rotation[src_safe]))

    new_slot_mask = torch.zeros(cap, dtype=torch.bool, device=dev)
    new_slot_mask[tgt] = True
    alive2 = (alive & ~split_done) | new_slot_mask

    # Final prune (gaussian_model.py:923-928); new slots have zero radii.
    # max_screen_size None (or inf) disables both size prunes.
    opac = torch.sigmoid(new_params.opacity[:, 0])
    radii_stat = torch.where(new_slot_mask, 0.0, stats.max_radii2d)
    prune = opac < min_opacity
    if max_screen_size is not None and max_screen_size != float("inf"):
        new_max_scale = torch.exp(new_params.scaling).max(dim=1).values
        prune = prune | (radii_stat > max_screen_size) | \
            (new_max_scale > 0.1 * extent)
    new_params = new_params.replace(alive=alive2 & ~prune)
    return new_params, DensifyStats.zeros(cap, dev), new_slot_mask, n_dropped


def reset_opacity(params: GaussianParams) -> GaussianParams:
    """opacity_new = sigmoid^-1(min(opacity, 0.01)) (ref reset_opacity,
    gaussian_model.py:467-472)."""
    op = torch.sigmoid(params.opacity)
    return params.replace(opacity=math_utils.inverse_sigmoid(
        torch.minimum(op, torch.full_like(op, 0.01))))
