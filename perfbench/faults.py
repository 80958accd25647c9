"""Faults planted under a run, to show that the check fails them: each
patches one module of the program (or of the reference, where that
stands in the program's place) for the length of a `with` block.

- `unchanged`: the training step returns the state it was given.
- `half_batch`: the photometric L1 sees the top half of the image only,
  its mean taken over that half (half the batch's pixels left out).
- `answer`: a served view's render_rgb is altered where it is made (one
  pixel's red channel, by 0.25).
A cell runs on one chip and exchanges nothing between chips, so there is
no exchange to leave out."""
from __future__ import annotations

import contextlib
import importlib

FAULTS = {"train": ("unchanged", "half_batch"), "serve": ("answer",)}


@contextlib.contextmanager
def _patched(module: str, name: str, make):
    mod = importlib.import_module(module)
    orig = getattr(mod, name)
    setattr(mod, name, make(orig))
    try:
        yield
    finally:
        setattr(mod, name, orig)


def _unchanged(make_step):
    def factory(*a, **k):
        step = make_step(*a, **k)

        def frozen(state, *args):
            return state, step(state, *args)[1]
        return frozen
    return factory


def _half_batch(l1_loss):
    def half(a, b):
        h = a.shape[-2] // 2
        return l1_loss(a[..., :h, :], b[..., :h, :])
    return half


def _answer(render_pbr_view):
    def altered(*a, **k):
        out = render_pbr_view(*a, **k)
        rgb = out["render_rgb"].clone()
        rgb[0, 0, 0] += 0.25
        return dict(out, render_rgb=rgb)
    return altered


@contextlib.contextmanager
def planted(fault: str, package: str):
    """The fault, planted in `package` (the program's or the reference's)."""
    if fault == "unchanged":
        with _patched(f"{package}.train.trainer", "make_phase1_step",
                      _unchanged), \
                _patched(f"{package}.train.trainer", "make_phase2_step",
                         _unchanged):
            yield
    elif fault == "half_batch":
        with _patched(f"{package}.utils.image_utils", "l1_loss", _half_batch):
            yield
    elif fault == "answer":
        with _patched(f"{package}.cli.render_cli", "render_pbr_view",
                      _answer):
            yield
    else:
        raise ValueError(f"no fault {fault!r}")
