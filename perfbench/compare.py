"""The numbers that decide `correct`: the program's readings against the
plain reference's, each with its limit from `limits/<cell>.json`."""
from __future__ import annotations

import statistics
from typing import Dict

import numpy as np

# a leaf whose reference gradient is under this share of the median
# leaf's moves by round-off alone under Adam: its change is not compared
DEAD_LEAF = 1e-3


def _gap(p: float, r: float, floor: float) -> float:
    return abs(p - r) / max(abs(r), floor, 1e-30)


def train_gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """loss_gap: the widest relative gap of a checked step's loss.
    grad_gap: the widest gap, over the leaves, between the norms of the
    first step's gradient, against the reference leaf's norm or the
    median leaf's, whichever is larger. change_gap: the same of the
    leaves' change over the checked steps, leaving out leaves whose
    reference gradient is nought to rounding."""
    loss = max(_gap(p, r, 0.0) for p, r in zip(prog["losses"], ref["losses"]))
    g_med = statistics.median(ref["grads"].values())
    grad = max(_gap(prog["grads"][k], g, g_med)
               for k, g in ref["grads"].items())
    live = [k for k, g in ref["grads"].items() if g >= DEAD_LEAF * g_med]
    c_med = statistics.median(ref["changes"][k] for k in live)
    change = max(_gap(prog["changes"][k], ref["changes"][k], c_med)
                 for k in live)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def view_gaps(prog: Dict[int, np.ndarray], ref: Dict[int, np.ndarray]
              ) -> Dict[str, float]:
    """view_max_abs: the widest gap of a pixel of a checked view's
    render_rgb; view_rmse: the root mean square gap of the checked
    views, the worst view's. views_failed: checked views with a
    non-finite pixel."""
    worst, rmse, bad = 0.0, 0.0, 0
    for i, p in prog.items():
        d = p.astype(np.float64) - ref[i].astype(np.float64)
        if not np.isfinite(p).all():
            bad += 1
            worst = rmse = float("inf")
            continue
        worst = max(worst, float(np.abs(d).max()))
        rmse = max(rmse, float(np.sqrt((d * d).mean())))
    if not prog:                     # nothing finished to check
        worst = rmse = float("inf")
    return {"view_max_abs": worst, "view_rmse": rmse, "views_failed": bad}


def checks(gaps: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """Every compared number beside its limit. A number that is not
    finite fails, and reads as the largest double."""
    return {k: {"value": float(v) if np.isfinite(v) else 1.7e308,
                "limit": limits[k]} for k, v in gaps.items()}
