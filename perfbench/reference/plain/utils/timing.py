"""Opt-in per-stage wall clock of the render and training paths. Off by
default (a `stage` is then a no-op); when on, each stage synchronises the
device at its start and end, so its seconds are the device work of that
stage."""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch

_totals: Optional[Dict[str, float]] = None


def start() -> None:
    global _totals
    _totals = {}


def stop() -> Dict[str, float]:
    """Turn timing off and return the seconds per stage since `start`."""
    global _totals
    out, _totals = _totals or {}, None
    return out


@contextlib.contextmanager
def suspended():
    """Leave the work inside the block out of the stage totals."""
    global _totals
    saved, _totals = _totals, None
    try:
        yield
    finally:
        _totals = saved


@contextlib.contextmanager
def stage(name: str, device: torch.device):
    if _totals is None:
        yield
        return
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda d: 0)
    sync(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sync(device)
        _totals[name] = _totals.get(name, 0.0) + time.perf_counter() - t0
