"""Per-group Adam of the Gaussian parameters (port of
gi_gs_tpu/train/optim.py; ref training_setup / update_learning_rate,
scene/gaussian_model.py:318-395).

A small Adam of the port's own on plain tensors, with the semantics of
the JAX optimizer (optax `scale_by_adam(b1=0.9, b2=0.999, eps=1e-15,
eps_root=0)` then the group's learning rate, then -1):
  mu = (1 - b1) g + b1 mu,  nu = (1 - b2) g^2 + b2 nu,  count += 1
  u = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
  p = p + (-(lr * u)),
where a scheduled group evaluates its schedule at its own count before
the increment (optax `scale_by_schedule`), so the first xyz step uses
expon_lr(0), whatever the trainer's iteration.

Preserved reference quirks: eps = 1e-15 (the first update is ~lr *
sign(g) for any nonzero g); the BRDF schedule applies with the hard-coded
`step - brdf_lr_offset` offset and is 0 before it; roughness and metallic
keep opacity_lr forever (the reference's early return at the albedo
group).

State: {group: {"mu": tensor, "nu": tensor, "count": int}}, one
parameter field per group.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from ..config import OptimizationConfig
from ..utils.math_utils import expon_lr

TRAINABLE_FIELDS = ("xyz", "features_dc", "features_rest", "opacity",
                    "normal", "albedo", "roughness", "metallic", "scaling",
                    "rotation")
GROUP_OF_FIELD = {
    "xyz": "xyz", "features_dc": "f_dc", "features_rest": "f_rest",
    "opacity": "opacity", "normal": "normal", "albedo": "albedo",
    "roughness": "roughness", "metallic": "metallic", "scaling": "scaling",
    "rotation": "rotation",
}
B1, B2, EPS = 0.9, 0.999, 1e-15

LR = Union[float, Callable[[int], float]]


def trainable_view(params) -> Dict[str, torch.Tensor]:
    return {f: getattr(params, f) for f in TRAINABLE_FIELDS}


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay^count, rounded once to f32 (a python float, so no host to
    device copy). optax computes it in f32 with XLA's pow, which is off by
    up to ~3e-5 relative (count 3, b2)."""
    return float(np.float32(1.0 - decay ** count))


def adam_init(p: torch.Tensor) -> Dict:
    return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p), "count": 0}


def adam_step(p: torch.Tensor, g: torch.Tensor, st: Dict, lr: LR):
    """One Adam update of one group: returns (new p, new state)."""
    count = st["count"] + 1
    mu = (1 - B1) * g + B1 * st["mu"]
    nu = (1 - B2) * (g * g) + B2 * st["nu"]
    bc1 = _bias_correction(B1, count)
    bc2 = _bias_correction(B2, count)
    u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
    step_size = lr(st["count"]) if callable(lr) else lr
    return p + (-(step_size * u)), {"mu": mu, "nu": nu, "count": count}


@dataclasses.dataclass
class GroupAdam:
    """Adam with one learning rate (a constant or a schedule of the
    group's own count) per parameter group."""
    lrs: Dict[str, LR]

    def init(self, view: Dict[str, torch.Tensor]) -> Dict[str, Dict]:
        return {GROUP_OF_FIELD.get(f, f): adam_init(p)
                for f, p in view.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], state: Dict[str, Dict],
             view: Dict[str, torch.Tensor]):
        """-> (updated view, new state)."""
        new_view, new_state = {}, {}
        for f, p in view.items():
            grp = GROUP_OF_FIELD.get(f, f)
            new_view[f], new_state[grp] = adam_step(p, grads[f], state[grp],
                                                    self.lrs[grp])
        return new_view, new_state


def _scaled(lr: LR, scale_fn) -> LR:
    """lr(step) * scale_fn(step), the product rounded to f32 as optax
    computes it (its schedules run in f32)."""
    if scale_fn is None:
        return lr
    base = lr if callable(lr) else (lambda step, v=lr: v)
    return lambda step: float(np.float32(base(step)) *
                              np.float32(scale_fn(step)))


def build_optimizer(opt: OptimizationConfig, spatial_lr_scale: float,
                    lr_scale_fn: Optional[Callable[[int], float]] = None
                    ) -> GroupAdam:
    """The reference's groups and schedules (optim.py:26-100);
    lr_scale_fn(step) multiplies every group's rate."""
    xyz_sched = lambda step: expon_lr(
        step, opt.position_lr_init * spatial_lr_scale,
        opt.position_lr_final * spatial_lr_scale,
        lr_delay_mult=opt.position_lr_delay_mult,
        max_steps=opt.position_lr_max_steps)
    brdf_sched = lambda step: expon_lr(
        step - opt.brdf_lr_offset, opt.opacity_lr, opt.BRDF_lr,
        lr_delay_mult=opt.position_lr_delay_mult, max_steps=10_000)
    lrs = {
        "xyz": xyz_sched, "f_dc": opt.feature_lr,
        "f_rest": opt.feature_lr / 20.0, "opacity": opt.opacity_lr,
        "normal": opt.opacity_lr, "albedo": brdf_sched,
        # quirk: roughness/metallic never rescheduled (ref early return)
        "roughness": opt.opacity_lr, "metallic": opt.opacity_lr,
        "scaling": opt.scaling_lr, "rotation": opt.rotation_lr,
    }
    return GroupAdam({k: _scaled(v, lr_scale_fn) for k, v in lrs.items()})


def build_light_optimizer(opt: OptimizationConfig) -> GroupAdam:
    """Cubemap Adam (train.py:215-218): lr = opacity_lr; its one group is
    called "cubemap"."""
    return GroupAdam({"cubemap": opt.opacity_lr})


def surgery_new_slots(state: Dict[str, Dict], slot_mask: torch.Tensor):
    """Zero the moments of re-allocated capacity slots (the reference's
    cat-zeros optimizer surgery, gaussian_model.py:635-662)."""
    out = {}
    for grp, st in state.items():
        m = slot_mask.reshape((-1,) + (1,) * (st["mu"].dim() - 1))
        out[grp] = {"mu": torch.where(m, 0.0, st["mu"]),
                    "nu": torch.where(m, 0.0, st["nu"]),
                    "count": st["count"]}
    return out


def surgery_grow(state: Dict[str, Dict], old_cap: int, new_cap: int):
    """Pad every group's moments with zeros from old_cap to new_cap rows
    (existing slots keep theirs exactly; counts kept)."""
    def pad(x):
        return torch.cat([x, x.new_zeros((new_cap - old_cap,) + x.shape[1:])])
    return {grp: {"mu": pad(st["mu"]), "nu": pad(st["nu"]),
                  "count": st["count"]} for grp, st in state.items()}


def surgery_reset_group(state: Dict[str, Dict], label: str):
    """Zero one group's moments, keeping its count (the opacity reset's
    replace_tensor_to_optimizer, gaussian_model.py:580-594)."""
    out = dict(state)
    st = state[label]
    out[label] = {"mu": torch.zeros_like(st["mu"]),
                  "nu": torch.zeros_like(st["nu"]), "count": st["count"]}
    return out
