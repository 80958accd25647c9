"""Places per training step where the program's host blocks on the device:
its host_syncs counter, one per sync.* span (window A). Nothing without
the program's spans (perfbench/spans.py)."""
from perfbench import spans


def read(t):
    return spans.counter(t, "host_syncs")
