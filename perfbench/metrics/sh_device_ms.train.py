"""Device-busy milliseconds per training step of the operations launched
under the program's spans sh and sh_bwd: the SH colour's forward and its
backward (window B). Nothing without the program's spans
(perfbench/spans.py), or where the program records neither of the two
(a program from before them)."""
from perfbench import spans

NAMES = ("sh", "sh_bwd")


def read(t):
    d = spans.of(t)
    if d is None or not any(s.name in NAMES for s in d.spans):
        return None
    return spans.device_ms(t, *NAMES)
