"""Timing and roofline utilities (port of gi_gs_tpu/utils/profiling.py).

`time_fn` fences with `torch.cuda.synchronize` on the card (PyTorch
returns before the device has finished); on the CPU the work is done
when the call returns. `StageTimes.report` states each stage beside its
roofline bound at the H100's published peaks (NVIDIA data sheet, SXM,
dense): 3.35 TB/s HBM and 67 TFLOP/s f32 outside the tensor cores, the
peaks PERF.md uses.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

H100_F32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, iters: int = 5, warmup: int = 1,
            **kwargs) -> Tuple[float, Any]:
    """Mean wall time (seconds) of fn(*args, **kwargs) over `iters` calls
    after `warmup` calls. The calls are issued back to back and the card
    (when there is one) synchronised once at the end. Returns (seconds,
    last output)."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
        _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    _sync()
    return (time.perf_counter() - t0) / iters, out


class StageTimes:
    """Accumulates named stage times; reports each with its roofline
    bound, given the work of the stage and the device's peaks."""

    def __init__(self) -> None:
        self.times: Dict[str, float] = {}

    def measure(self, name: str, fn: Callable, *args, **kwargs):
        dt, out = time_fn(fn, *args, **kwargs)
        self.times[name] = dt
        return out

    def report(self, work: Optional[Dict[str, Dict[str, float]]] = None,
               peak_flops: float = H100_F32_FLOPS,
               peak_bw: float = H100_HBM_BYTES_PER_S
               ) -> Dict[str, Dict[str, float]]:
        """{stage: {"ms"[, "roofline_ms", "of_roofline"]}}. work: {stage:
        {"flops": F, "bytes": B}}; the bound is the larger of F over
        `peak_flops` and B over `peak_bw`, and of_roofline the stage's
        time over it."""
        out = {}
        for name, dt in self.times.items():
            row = {"ms": dt * 1e3}
            if work and name in work:
                w = work[name]
                bound = max(w.get("flops", 0) / peak_flops,
                            w.get("bytes", 0) / peak_bw)
                row["roofline_ms"] = bound * 1e3
                row["of_roofline"] = dt / max(bound, 1e-12)
            out[name] = row
        return out
