"""Rasterizer parameters (same fields and defaults as gi_gs_tpu's
RasterConfig, so a `cfg_args.json` written by the JAX trainer loads
unchanged). On the GPU every size is a run-time value; the fields that
were TPU compile-time capacities keep their meaning:

cap_instances: length of the (gaussian, tile) instance list; rows beyond
  it are dropped and counted in `overflow`.
cap_tile: most instances composited per tile (front-to-back order).
chunk: instances per compositing step of the plain version; the CUDA
  kernel walks instances one by one (`chunks_per_tile * chunk` bounds it).
use_pallas / expand_backend: accepted for config compatibility; the port
  has one path per stage (its CUDA kernels, or their plain versions for
  CPU tensors).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    tile_h: int = 16
    tile_w: int = 64
    cap_instances: int = 1 << 21
    cap_tile: int = 4096
    chunk: int = 64
    use_pallas: bool = True
    expand_backend: str = "pallas"
    # tiles per plain compositing call (0: all at once); the reference
    # composites in blocks so that a full-size image fits
    tile_block: int = 0

    # Frustum / numeric constants (cuda_rasterizer semantics)
    near: float = 0.2            # auxiliary.h:166
    lowpass: float = 0.3         # forward.cu:119-120
    alpha_clamp: float = 0.99    # forward.cu:369
    alpha_min: float = 1.0 / 255.0
    t_min: float = 1e-4          # forward.cu:374

    def grid(self, height: int, width: int) -> tuple[int, int]:
        ty = -(-height // self.tile_h)
        tx = -(-width // self.tile_w)
        return ty, tx

    @property
    def pixels_per_tile(self) -> int:
        return self.tile_h * self.tile_w

    @property
    def chunks_per_tile(self) -> int:
        return self.cap_tile // self.chunk
