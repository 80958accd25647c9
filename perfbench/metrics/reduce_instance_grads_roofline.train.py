"""The compositing backward's reduction to Gaussians, % of its roofline in
the first traced training step: the bound of the work that step's
inputs need over the device time of its three launches (scan, carry,
differences).

Bytes, the least any implementation moves: the gradient rows the
binning made read once ([rows, 21] f32: one per (Gaussian, tile) pair
and at least one per Gaussian, up to the binning's last segment bound,
clamped to the instance capacity; a culled pair's or an unseen
Gaussian's row is zero, but nothing tells which), the sorted Gaussian id
of each row read once (int32), and the per-Gaussian sums written once
([Gaussians, 21] f32). Operations: one add per element of a row."""
from perfbench import work

KERNELS = ("reduce_scan", "reduce_carry", "reduce_diff")


def nbytes(rows: int, gaussians: int) -> int:
    return rows * (work.TABLE_DIM * 4 + 4) + gaussians * work.TABLE_DIM * 4


def count(t):
    g = work.gbuffer(t)
    if g is None:
        return None
    offsets = g["binning"].offsets
    rows = min(int(offsets[-1]), g["raster"].cap_instances)
    if not rows:
        return None
    return nbytes(rows, offsets.numel() - 1), rows * work.TABLE_DIM


def read(t):
    ms = [t.kernel_ms(k) for k in KERNELS]
    if not all(ms):
        return None
    c = count(t)
    if c is None:
        return None
    return work.share(c[0], c[1], sum(m[0] for m in ms) * 1e-3)
