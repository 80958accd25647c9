"""Device-busy milliseconds per training step of the operations launched
under the program's span adam: the Adam updates of the Gaussians' groups
and, in phase 2, of the cubemap (window B). Nothing without the
program's spans (perfbench/spans.py), or where the program records no
adam span (a program from before it)."""
from perfbench import spans

NAMES = ("adam",)


def read(t):
    d = spans.of(t)
    if d is None or not any(s.name in NAMES for s in d.spans):
        return None
    return spans.device_ms(t, *NAMES)
