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

On CUDA tensors a step is one launch of the kernel `adam`
(csrc/adam.cu) over every group, with the chain's bits on the card; CPU
tensors take the chain (`adam_step`). Each step is the span `adam`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from ..config import OptimizationConfig
from ..ops import cuda_kernels as ck
from ..utils import timing
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
# the chain's Python-float scalars as the card's kernels round them
F32_CONSTANTS = tuple(float(np.float32(v))
                      for v in (1 - B1, B1, 1 - B2, B2, EPS))

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
    return p + (-(_rate(lr, st["count"]) * u)), \
        {"mu": mu, "nu": nu, "count": count}


def _rate(lr: LR, count: int) -> float:
    """The group's rate for the step from `count` (before the
    increment)."""
    return lr(count) if callable(lr) else lr


def adam_scalars(count: int, rate: float) -> np.ndarray:
    """f32 [rate, 1 / bc1, 1 / bc2] of the step to `count` (after the
    increment), as `adam_step` rounds them on the card: a Python-float
    factor is rounded to f32 once, and PyTorch's CUDA division by a CPU
    scalar multiplies by the f32 reciprocal of its f32 value."""
    one = np.float32(1.0)
    return np.array([np.float32(rate),
                     one / np.float32(_bias_correction(B1, count)),
                     one / np.float32(_bias_correction(B2, count))],
                    np.float32)


def adam_table(groups) -> tuple:
    """The host table of one `adam` launch over `groups`, a sequence of
    (p, g, mu, nu, p_out, mu_out, nu_out, scalars): int64 [G, 8] of the
    seven data pointers and the element count, f32 [G, 3] of the
    scalars."""
    ptrs = np.array([[t.data_ptr() for t in grp[:7]] + [grp[0].numel()]
                     for grp in groups], np.int64).reshape(-1, 8)
    scalars = np.array([grp[7] for grp in groups],
                       np.float32).reshape(-1, 3)
    return ptrs, scalars


def adam_cuda(items) -> list:
    """One `adam` launch over `items`, a sequence of (name, p, g, state,
    rate) of contiguous f32 CUDA tensors on one device: returns each
    group's (new p, new state), bit for bit `adam_step`'s on the card."""
    dev = items[0][1].device
    groups, out = [], []
    for name, p, g, st, rate in items:
        for what, t in (("p", p), ("g", g), ("mu", st["mu"]),
                        ("nu", st["nu"])):
            ck.check(t, f"{name}.{what}", torch.float32, p.shape, dev)
        new = [torch.empty_like(p) for _ in range(3)]
        count = st["count"] + 1
        groups.append((p, g, st["mu"], st["nu"], *new,
                       adam_scalars(count, rate)))
        out.append((new[0], {"mu": new[1], "nu": new[2], "count": count}))
    ptrs, scalars = adam_table(groups)
    ck.launch("adam", dev, ptrs.ctypes.data, scalars.ctypes.data,
              len(groups), *F32_CONSTANTS)
    return out


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
        groups = {f: GROUP_OF_FIELD.get(f, f) for f in view}
        with timing.span("adam"):
            if next(iter(view.values())).is_cuda:
                # normal's and albedo's gradients arrive as column-major
                # slices of the compositing table's, the cubemap's with its
                # channels outermost: one copy each
                got = adam_cuda([
                    (f, p, grads[f].contiguous(), state[groups[f]],
                     _rate(self.lrs[groups[f]], state[groups[f]]["count"]))
                    for f, p in view.items()])
            else:
                got = [adam_step(p, grads[f], state[groups[f]],
                                 self.lrs[groups[f]])
                       for f, p in view.items()]
        return ({f: p for f, (p, _) in zip(view, got)},
                {groups[f]: st for f, (_, st) in zip(view, got)})


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
