"""The SH colour's forward and backward, % of their roofline: the least
bytes of the layer over the device time of the operations launched under
the program's spans sh and sh_bwd (window B, per step), against the
HBM's rate: `sh_device_ms.train`'s time. Nothing where that reads
nothing, or where the spans launched nothing on a device.

Bytes, the least any implementation moves, counted over the live
Gaussians n at the active degree (K = (deg+1)^2 coefficients): the
forward reads the mean (12 B) and the coefficients (12K B) and writes
the colour (12 B); the backward reads the colour's gradient (12 B), the
mean (12 B) and the coefficients (12K B) and writes their gradients
(12K + 12 B). The count reads the same whatever implements the layer."""
from perfbench import cells, work


def nbytes(n: int, deg: int) -> int:
    K = (deg + 1) ** 2
    return n * (36 * K + 60)


def read(t):
    x = getattr(t, "inputs", None)
    ms = cells.metric_reader("sh_device_ms.train")(t)
    if x is None or not ms:
        return None
    return work.share(nbytes(x.cell.config["n_gaussians"], x.sh[0]), 0.0,
                      ms * 1e-3)
