"""Data- and tile-parallel training over `torch.distributed` process
groups (port of gi_gs_tpu/parallel/)."""
