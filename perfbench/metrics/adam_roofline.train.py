"""The Adam updates, % of their roofline: the least bytes of the layer
over the device time of the operations launched under the program's
span adam (window B, per step), against the HBM's rate:
`adam_device_ms.train`'s time. Nothing where that reads nothing, or
where the span launched nothing on a device.

Bytes, the least any implementation moves: each trained element (every
trained field of the live Gaussians, and the cubemap where the light
trains: `work.trained_elements`) reads its parameter, gradient and two
moments and writes the parameter and the two moments, 28 B. The count
reads the same whatever implements the layer."""
from perfbench import cells, work

BYTES_PER_ELEMENT = 28


def read(t):
    ms = cells.metric_reader("adam_device_ms.train")(t)
    if getattr(t, "inputs", None) is None or not ms:
        return None
    return work.share(BYTES_PER_ELEMENT * work.trained_elements(t), 0.0,
                      ms * 1e-3)
