"""Device-busy milliseconds per served view of the operations launched
under the program's span light: the prefilter of a relit view's new
environment (window B). Nothing without the program's spans
(perfbench/spans.py), or where no span light was opened."""
from perfbench import spans


def read(t):
    d = spans.of(t)
    if d is None or not any(s.name == "light" for s in d.spans):
        return None
    return spans.device_ms(t, "light")
