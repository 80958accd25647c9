"""Device-busy milliseconds per training step of the operations launched
under the program's spans ssao and ssr (window B). Nothing without the
program's spans (perfbench/spans.py)."""
from perfbench import spans


def read(t):
    return spans.device_ms(t, "ssao", "ssr")
