"""Milliseconds per view in the screen-space marches: the program's
stages ssao and ssr. Read from the sync-fenced
stage window, never the profiled one."""


def read(t):
    return t.stages("ssao", "ssr")
