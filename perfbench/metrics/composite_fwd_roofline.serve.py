"""The compositing forward's % of its roofline in the first traced view:
the bound of the work that view's inputs need over the launch's device
time.

Bytes: each input read once (the table rows of the Gaussians the
instance list names, the instance ids, the tile ranges) and each output
written once (16 accumulated channels and the final transmittance per
pixel). Operations: perfbench/work.py's per-pair count of the forward
walk."""
from perfbench import work


def count(t):
    w = work.composite_walk(t)
    if not w or not w["pairs"]:
        return None
    nbytes = (w["rows"] * work.TABLE_DIM * 4 + w["instances"] * 4
              + w["tiles"] * 8 + w["pixels"] * 4 * (work.NUM_CH + 1))
    return nbytes, work.composite_flops(w, "fwd")


def read(t):
    return work.roofline(t, "composite_fwd", 1, count)
