"""Tile-sharded rendering and training (port of
gi_gs_tpu/parallel/tile_sharded.py): one image's pixel tiles split over
the ranks of a `torch.distributed` process group.

The Gaussian state is replicated; preprocess and binning run on every
rank (identical work); the compositing is sharded by contiguous tile
ranges (the kernels' `tile_base`) and an all_gather reassembles the full
G-buffer on every rank (`pipeline._composite_local_tiles`).

* `sharded_composite`: the compositing call alone (eval, diagnostics);
* `make_ts_phase1_step`: the tile-sharded phase-1 training step. Each
  rank's backward sees only its own tiles' cotangents, so its parameter
  gradients are partials; they are summed once over the group, which
  gives the single-device gradient. The optimizer, densification and
  opacity resets then run replicated: identical inputs and the same
  seeded densify generator keep every rank's state bit-identical.

The JAX step differentiates inside its shard_map, where the transpose of
all_gather adds n_shards equal cotangents before the psum: its gradients
and densification statistics are n_shards times the single-chip ones
(a reference-side caveat, ROADMAP.md). This port gives the single-device
gradient, as the JAX docstring says the partials must.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from ..config import Config
from ..ops.rasterize import RasterConfig
from ..ops.rasterize.binning import Binning
from ..ops.rasterize.pipeline import _composite_local_tiles
from ..scene.cameras import Camera
from ..train.optim import GroupAdam
from ..train.trainer import (StepAux, TrainState, _apply_schedule_updates,
                             loss_and_grads)
from ..utils import image_utils, timing
from . import collectives


def sharded_composite(group, table: torch.Tensor, binning: Binning,
                      cfg: RasterConfig, grid: Tuple[int, int],
                      image_hw: Tuple[int, int]):
    """Composite with the tiles sharded over `group`: returns the full
    (accum [T, 16, P], final_t [T, P]) on every rank. Differentiable in
    `table`; the gradient is this rank's partial (sum it over the
    group)."""
    return _composite_local_tiles(table, binning, cfg, grid, image_hw,
                                  dist.group.WORLD if group is None else group)


def make_ts_phase1_step(cfg: Config, cameras_extent: float, tx: GroupAdam,
                        group=None):
    """Returns step(state, camera, image, alpha, bg, iteration) ->
    (state, StepAux), one camera per step as the reference, every
    argument the same on every rank of `group` (None: the default
    group). Collectives per step: the all_gather of the compositing and
    one all_reduce of the gradient partials."""
    group = dist.group.WORLD if group is None else group

    @timing.spanned("step")
    def step(state: TrainState, camera: Camera, image, alpha, bg,
             iteration: int):
        loss, aux, grads, ndc_grad = loss_and_grads(
            cfg, state.params, camera, image, alpha, bg, tile_group=group)
        names = list(grads)
        *summed, ndc_grad = collectives.all_reduce_flat(
            [grads[k] for k in names] + [ndc_grad], group, mean=False)
        new_state, dropped = _apply_schedule_updates(
            cfg, state, dict(zip(names, summed)), ndc_grad, aux,
            int(iteration), tx, cameras_extent)
        with torch.no_grad():
            psnr = image_utils.psnr(aux["render"], aux["gt"])
        return new_state, StepAux(loss, aux["l1"].detach(),
                                  aux["normal_loss"].detach(), psnr, dropped,
                                  aux["overflow"], aux["max_tile_count"])

    return step
