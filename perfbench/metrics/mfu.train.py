"""The whole training step's % of the H100's f32 peak: the operations
its algorithm needs on the first traced step's inputs over a step's
time in the traced run's unprofiled, unfenced window.

Counted (perfbench/work.py's walks): compositing's forward and backward
walk, the SSAO and SSR marches where the step runs them (phase 2 with
--indirect), and Adam over every trained element. Left out, so the
reading is low: preprocess, binning, shading, the light's filters and
the losses."""
from perfbench import work


def flops(t):
    w = work.composite_walk(t)
    if not w:
        return None
    x = t.inputs
    f = work.composite_flops(w, "fwd") + work.composite_flops(w, "bwd")
    if x.cell.traffic.get("phase") == 2 and x.cfg.train.indirect:
        f += sum(work.march_flops(m) for m in work.march_walks(t))
    return f + work.ADAM_ELEMENT * work.trained_elements(t)


def read(t):
    return work.mfu(t, flops(t))
