"""Device-busy milliseconds per training step of the operations launched
under the program's span composite_bwd: the kernel and the reduction to
Gaussians (window B). Nothing without the program's spans
(perfbench/spans.py)."""
from perfbench import spans


def read(t):
    return spans.device_ms(t, "composite_bwd")
