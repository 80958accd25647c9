"""Milliseconds per training step in the light: the program's stages
build_mips (the prefiltered mips of the cubemap) and env_tv. Read from the sync-fenced
stage window, never the profiled one."""


def read(t):
    return t.stages("build_mips", "env_tv")
