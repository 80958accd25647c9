"""Table rows that probe the compositing kernels' sub-tile cull: opacity
0.99, at, just above and just below 1/255, and 0; thin anisotropic and
nearly degenerate conics; degenerate ones (singular, indefinite, negative,
zero, NaN); means spread around the sub-tiles or placed so that each
ellipse's exact alpha_min extent grazes a sub-tile's edge pixel. Shared by
the CPU tests of the cull's plain twin and the card tests of the kernels,
so it imports neither JAX nor the JAX package."""
import numpy as np
import torch

AMIN = np.float32(1.0 / 255.0)


def conics(rng, n, lo=-1.2, hi=2.8):
    """Inverse of random 2D covariances (eigenvalues 10^U(lo, hi) px^2,
    any orientation) as [n, 3] (a, b, c), float64."""
    ev = 10.0 ** rng.uniform(lo, hi, (n, 2))
    th = rng.uniform(0, np.pi, n)
    cs, sn = np.cos(th), np.sin(th)
    sxx = ev[:, 0] * cs ** 2 + ev[:, 1] * sn ** 2
    syy = ev[:, 0] * sn ** 2 + ev[:, 1] * cs ** 2
    sxy = (ev[:, 0] - ev[:, 1]) * cs * sn
    det = sxx * syy - sxy ** 2
    return np.stack([syy / det, -sxy / det, sxx / det], 1)


def opacities(rng, n):
    up, down = np.nextafter(AMIN, np.float32(1)), np.nextafter(AMIN,
                                                                np.float32(0))
    choice = np.array([0.99, AMIN, up, down, 0.0, 0.02], np.float32)
    op = rng.uniform(AMIN, 1.0, n).astype(np.float32)
    special = rng.uniform(size=n) < 0.5
    op[special] = choice[rng.randint(0, len(choice), special.sum())]
    return op


def cull_rows(rng, n, rects, graze):
    """Table rows [n, 21] f32: random means around the rectangles (or,
    with `graze`, each ellipse's exact alpha_min extent touching an edge
    pixel of a random rectangle to within 0.05 px), conics and
    opacities."""
    abc = conics(rng, n)
    op = opacities(rng, n)
    mean = rng.uniform(-24, 88, (n, 2))
    if graze:
        a, b, c = abc.T
        det = a * c - b * b
        tau = 2 * np.log(np.maximum(op.astype(np.float64), 1e-30) / AMIN)
        tau = np.maximum(tau, 1e-12)
        hx, hy = np.sqrt(tau * c / det), np.sqrt(tau * a / det)
        r = rects[rng.randint(0, len(rects), n)]      # x0, x1, y0, y1
        eps = rng.uniform(-0.05, 0.05, n)
        side = rng.randint(0, 4, n)
        # the extreme point of the ellipse along +-x is d = +-(hx, -b hx / c),
        # along +-y is d = +-(-b hy / a, hy); put it on an edge pixel
        ex = np.where(side < 2, np.where(side == 0, r[:, 0], r[:, 1]),
                      rng.randint(r[:, 0], r[:, 1] + 1))
        ey = np.where(side >= 2, np.where(side == 2, r[:, 2], r[:, 3]),
                      rng.randint(r[:, 2], r[:, 3] + 1))
        sgn = np.where(side % 2 == 0, -1.0, 1.0)
        dxy = np.where((side < 2)[:, None],
                       np.stack([hx - eps, -b * hx / c], 1),
                       np.stack([-b * hy / a, hy - eps], 1))
        mean = np.stack([ex, ey], 1) + sgn[:, None] * dxy
    rows = np.zeros((n, 21), np.float32)
    rows[:, 0:2] = mean
    rows[:, 2:5] = abc
    rows[:, 5] = op
    # degenerate conics: singular, indefinite, negative, zero, NaN
    k = n // 20
    bad = np.array([[1.0, 1.0, 1.0], [0.1, 0.5, 0.1], [-0.2, 0.0, -0.3],
                    [0.0, 0.0, 0.0], [np.nan, 0.0, 0.2],
                    [1e-6, 0.0, 1e-6]], np.float32)
    rows[:k, 2:5] = bad[rng.randint(0, len(bad), k)]
    rows[:, 6:] = rng.uniform(0, 1, (n, 15))
    return torch.as_tensor(rows)
