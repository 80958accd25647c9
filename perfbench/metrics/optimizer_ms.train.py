"""Milliseconds per training step in the optimizers: the program's
stages optimizer and light_optimizer. Read from the sync-fenced
stage window, never the profiled one."""


def read(t):
    return t.stages("optimizer", "light_optimizer")
