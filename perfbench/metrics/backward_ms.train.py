"""Milliseconds per training step in the backward pass (the program's
stage backward). Read from the sync-fenced
stage window, never the profiled one."""


def read(t):
    return t.stages("backward")
