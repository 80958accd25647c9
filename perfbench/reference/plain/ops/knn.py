"""Mean squared distance to the 3 nearest neighbours, the scale init
(port of gi_gs_tpu/ops/knn.py; ref submodules/simple-knn).

Two paths, as in JAX: an exact chunked brute force up to 2^18 points (the
distance matmul goes to `torch.matmul`, as JAX leaves it to XLA), and
beyond that the Morton-window estimate: points sorted by a 30-bit Morton
code (a stable sort), each compared with its +-48 Morton neighbours, over
three decorrelated orderings whose elementwise minimum is kept.
"""
from __future__ import annotations

import torch

EXACT_MAX = 1 << 18


def _three_smallest_mean(d2: torch.Tensor, skip_first: bool = False
                         ) -> torch.Tensor:
    """Mean of the 3 smallest entries per row, removing one first
    occurrence of the minimum per pass (and, with skip_first, a first pass
    that drops the self-distance without counting it)."""
    d2 = d2.clone()
    rows = torch.arange(d2.shape[0], device=d2.device)
    total = torch.zeros(d2.shape[0], dtype=d2.dtype, device=d2.device)
    for k in range(4 if skip_first else 3):
        m, first = d2.min(dim=1)
        if k > 0 or not skip_first:
            total = total + m
        d2[rows, first] = float("inf")
    return total / 3.0


def mean_knn_dist2_exact(points: torch.Tensor, chunk: int = 512
                         ) -> torch.Tensor:
    """Exact brute force: [N, 3] -> [N]."""
    sq = (points * points).sum(-1)
    out = []
    for s in range(0, points.shape[0], chunk):
        q = points[s:s + chunk]
        d2 = (q * q).sum(-1)[:, None] + sq[None, :] - 2.0 * (q @ points.T)
        out.append(_three_smallest_mean(torch.clamp(d2, min=0.0),
                                        skip_first=True))
    return torch.cat(out)


def _spread(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def _morton_3d(q: torch.Tensor) -> torch.Tensor:
    """[N, 3] int32 in [0, 1023] -> 30-bit interleaved Morton code."""
    return _spread(q[:, 0]) | (_spread(q[:, 1]) << 1) | (_spread(q[:, 2]) << 2)


def _morton_pass(points: torch.Tensor, window: int, shift: float, perm
                 ) -> torch.Tensor:
    n = points.shape[0]
    lo = points.min(dim=0).values
    hi = points.max(dim=0).values
    q = ((points - lo) / torch.clamp(hi - lo, min=1e-9) * 1023.0 + shift
         ).to(torch.int32)
    code = _morton_3d(torch.clamp(q[:, list(perm)], 0, 1023))
    _, order = torch.sort(code, stable=True)
    sorted_pts = points[order]
    pad = torch.full((window, 3), 1e8, dtype=points.dtype,
                     device=points.device)
    padded = torch.cat([pad, sorted_pts, pad], dim=0)
    offsets = list(range(-window, 0)) + list(range(1, window + 1))
    cands = torch.stack([padded[window + o: window + o + n] for o in offsets],
                        dim=1)                                 # [N, 2W, 3]
    d2 = ((cands - sorted_pts[:, None, :]) ** 2).sum(-1)
    mean3 = _three_smallest_mean(d2)
    out = torch.empty_like(mean3)
    out[order] = mean3
    return out


def mean_knn_dist2_morton(points: torch.Tensor, window: int = 48
                          ) -> torch.Tensor:
    """Elementwise minimum over three Morton orderings (identity, half-cell
    shift, permuted axis interleave) of the windowed 3-NN estimate."""
    est = _morton_pass(points, window, 0.0, (0, 1, 2))
    est = torch.minimum(est, _morton_pass(points, window, 0.5, (0, 1, 2)))
    return torch.minimum(est, _morton_pass(points, window, 0.0, (2, 0, 1)))


def mean_knn_dist2(points: torch.Tensor) -> torch.Tensor:
    """Exact up to 2^18 points, Morton-window estimate beyond."""
    if points.shape[0] <= EXACT_MAX:
        return mean_knn_dist2_exact(points)
    return mean_knn_dist2_morton(points)
