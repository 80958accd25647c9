"""Collectives of the parallel training paths, as plain functions on a
`torch.distributed` process group (`None`: the default group). They are
the torch form of the `jax.lax` collectives that the JAX package's
shard_map steps use (gi_gs_tpu/parallel/*.py):

* `all_reduce_flat`: `psum` / `pmean` of many tensors in ONE flattened
  all_reduce (the gradients of a step);
* `all_reduce_max`: `pmax` of many integer or boolean tensors in one
  packed all_reduce (visibility, radii, overflow, max_tile_count);
* `all_gather_tiles`: the tiled `all_gather` of the tile-sharded
  compositing, differentiable.

`all_gather_tiles`' backward returns this rank's rows of the cotangent
and communicates nothing. Every rank computes the same loss from the
gathered image, so that slice is this rank's share of the single-device
cotangent; the caller sums the partial parameter gradients once
(`all_reduce_flat(..., mean=False)`), which gives the single-device
gradient. (JAX transposes its all_gather into a psum-scatter of the
n_shards equal cotangents and then psums the partials, which scales the
gradient by n_shards.)

`calls` counts the collectives issued, by kind; a run sets the counts to
0 (`reset_calls`) and reads them afterwards.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

calls: Dict[str, int] = {"all_reduce": 0, "all_gather": 0}


def reset_calls() -> None:
    for k in calls:
        calls[k] = 0


def rank_and_size(group: Optional[dist.ProcessGroup]) -> Tuple[int, int]:
    """This process's rank in `group` and the group's size."""
    return dist.get_rank(group), dist.get_world_size(group)


def _split_like(flat: torch.Tensor, like: Sequence[torch.Tensor]
                ) -> List[torch.Tensor]:
    out, i = [], 0
    for t in like:
        n = t.numel()
        out.append(flat[i:i + n].reshape(t.shape))
        i += n
    return out


def all_reduce_flat(tensors: Sequence[torch.Tensor],
                    group: Optional[dist.ProcessGroup], mean: bool = True
                    ) -> List[torch.Tensor]:
    """The sum (or, with `mean`, the mean) over the group of each f32
    tensor, through one all_reduce of their concatenation. Returns new
    tensors of the input shapes; every rank gets the same values."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    calls["all_reduce"] += 1
    if mean:
        flat = flat / rank_and_size(group)[1]
    return _split_like(flat, tensors)


def all_reduce_max(tensors: Sequence[torch.Tensor],
                   group: Optional[dist.ProcessGroup]) -> List[torch.Tensor]:
    """The elementwise maximum over the group of each integer or boolean
    tensor, through one all_reduce of their concatenation as int64.
    Returns tensors of the input shapes and dtypes (a boolean is the OR
    over ranks)."""
    flat = torch.cat([t.reshape(-1).to(torch.int64) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.MAX, group=group)
    calls["all_reduce"] += 1
    return [r.to(t.dtype) for r, t in zip(_split_like(flat, tensors),
                                           tensors)]


class _TileAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *parts):
        rank, world = rank_and_size(group)
        n = parts[0].shape[0]
        flat = torch.cat([p.reshape(n, -1) for p in parts], 1).contiguous()
        pieces = [torch.empty_like(flat) for _ in range(world)]
        dist.all_gather(pieces, flat, group=group)
        calls["all_gather"] += 1
        full = torch.cat(pieces, 0)
        ctx.rows = (rank * n, (rank + 1) * n)
        outs, col = [], 0
        for p in parts:
            w = p[0].numel()
            outs.append(full[:, col:col + w].reshape(
                (world * n,) + tuple(p.shape[1:])).contiguous())
            col += w
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        lo, hi = ctx.rows
        return (None,) + tuple(None if g is None else g[lo:hi]
                               for g in grads)


def all_gather_tiles(parts: Sequence[torch.Tensor],
                     group: Optional[dist.ProcessGroup]
                     ) -> Tuple[torch.Tensor, ...]:
    """Each tensor of `parts` ([T_local, ...], the same T_local on every
    rank) gathered over the group along dim 0 in rank order ([world *
    T_local, ...]), all through one all_gather. Differentiable: the
    backward keeps this rank's rows of each cotangent (module docstring)."""
    return _TileAllGather.apply(group, *parts)
