"""Device idle milliseconds per training step in gaps that open inside a
sync.* span of the program, or after one and before the next launch
(window B). Nothing without the program's spans (perfbench/spans.py)."""
from perfbench import spans


def read(t):
    return spans.sync_idle_ms(t)
