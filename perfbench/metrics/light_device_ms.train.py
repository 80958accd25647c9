"""Device-busy milliseconds per training step of the operations launched
under the program's spans build_mips, env_tv and light_bwd: the light's
forward and backward (window B). Nothing without the program's spans
(perfbench/spans.py)."""
from perfbench import spans


def read(t):
    return spans.device_ms(t, "build_mips", "env_tv", "light_bwd")
