"""Milliseconds per view in the rasterizer: the program's stages
preprocess, binning and composite. Read from the sync-fenced
stage window, never the profiled one."""


def read(t):
    return t.stages("preprocess", "binning", "composite")
