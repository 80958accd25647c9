"""Device selection for the port's entry points, constant tables kept on
the device, and the card's name and power limit."""
from __future__ import annotations

import subprocess
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

_constants: Dict[tuple, torch.Tensor] = {}


def device_constant(build: Callable[..., np.ndarray], *args,
                    device: Union[str, torch.device]) -> torch.Tensor:
    """`build(*args)` (a numpy table) as a tensor on `device`, copied there
    once per (build, args, device) and reused, so a per-view caller does
    not pay a host-to-device copy each call. Made outside inference mode,
    so autograd code may also use it."""
    key = (build, args, canonical(device))
    t = _constants.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = torch.as_tensor(build(*args), device=device)
        _constants[key] = t
    return t


def canonical(device: Union[str, torch.device]) -> torch.device:
    """`device` with its index: "cuda" is the current card, so that a table
    kept for "cuda" and one kept for "cuda:0" are the same table."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` means the card. Asking for CUDA without one raises: nothing
    falls back to the CPU on its own (pass "cpu" for that)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gi_gs_tpu_torch: no CUDA device is available; pass "
            "device='cpu' (or --device cpu) to run on the CPU")
    return dev


def card_line(device: Union[str, torch.device]) -> str:
    """The card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them (for
    a CUDA device), or "cpu"; a result is read beside this line, since a
    card set below its full power limit runs slower under load."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={idx}"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{torch.cuda.get_device_name(idx)}, power limit not read ({e})"
    if res.returncode != 0:
        return (f"{torch.cuda.get_device_name(idx)}, power limit not read "
                f"({res.stderr.strip()})")
    return res.stdout.strip()
