"""The whole served view's % of the H100's f32 peak: the operations its
algorithm needs on the first traced view's inputs over a view's time in
the traced run's unprofiled, unfenced window.

Counted (perfbench/work.py's walks): compositing's forward walk and the
SSAO and SSR marches. Left out, so the reading is low: preprocess,
binning, shading and the host copy."""
from perfbench import work


def flops(t):
    w = work.composite_walk(t)
    if not w:
        return None
    return work.composite_flops(w, "fwd") + \
        sum(work.march_flops(m) for m in work.march_walks(t))


def read(t):
    return work.mfu(t, flops(t))
