"""The compositing backward's % of its roofline in the first traced
training step: the bound of the work that step's inputs need over the
launch's device time.

Bytes: each input read once (the table rows of the Gaussians the
instance list names, the instance ids, the tile ranges, the forward's
accumulators and final transmittance, the cotangents of the 16
channels) and each output written once (a table row's gradient per
instance). Operations: perfbench/work.py's per-pair count of the
backward walk."""
from perfbench import work


def count(t):
    w = work.composite_walk(t)
    if not w or not w["pairs"]:
        return None
    nbytes = (w["rows"] * work.TABLE_DIM * 4 + w["instances"] * 4
              + w["tiles"] * 8 + w["pixels"] * 4 * (4 + 1 + work.NUM_CH + 1)
              + w["instances"] * work.TABLE_DIM * 4)
    return nbytes, work.composite_flops(w, "bwd")


def read(t):
    return work.roofline(t, "composite_bwd", 1, count)
