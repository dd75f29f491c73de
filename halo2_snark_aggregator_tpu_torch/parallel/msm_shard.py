"""The MSM sharded over the ranks of a process group.

Port of halo2_snark_aggregator_tpu/parallel/msm_shard.py (`msm_sharded`,
`msm_sharded_host`). Each rank takes its chunk of the points and scalars
(`chunk_bounds`; no padding: the split plan takes any number of points, so
a chunk may be empty), builds the accumulate kernel's affine table of that
chunk alone and runs `ops/msm.msm_totals` on it: the split plan on the
device, the accumulate kernel, the reduce kernel. The ranks' row totals
and window weights are all-gathered (each rank has its own number of
rows), and every rank combines all of them with `combine_rows_host`, one
native Pippenger call, so every rank returns the same affine point. The
reference folds one Jacobian partial a device with the complete add
instead; the rows carry the same sum.

The reference's `*_lite` engines exist only to dodge XLA compile times
and are not ported.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import device as dv
from ..ops import field as fo
from ..ops import msm as msm_ops
from . import group as pg


def chunk_bounds(n: int, rank: int, world: int) -> tuple[int, int]:
    """[lo, hi) of rank's chunk of n items: near-equal, in rank order; a
    rank's chunk is empty when n < world."""
    return n * rank // world, n * (rank + 1) // world


def my_chunk(n: int, group=None) -> tuple[int, int]:
    return chunk_bounds(n, dist.get_rank(group), dist.get_world_size(group))


def local_rows(table, scalars: torch.Tensor, c: int):
    """`msm_totals` of this rank's chunk: (totals (R, 3, 8), weights (R,)),
    both on the scalars' device; no rows for an empty chunk."""
    if scalars.shape[0] == 0:
        return (scalars.new_zeros((0, 3, fo.WORDS)),
                scalars.new_zeros((0,)))
    return msm_ops.msm_totals(table, scalars, c)


def gather_rows(totals: torch.Tensor, weights: torch.Tensor, group=None):
    """Every rank's rows, concatenated in rank order: (totals, weights)."""
    return (torch.cat(pg.all_gather(totals, group)),
            torch.cat(pg.all_gather(weights, group)))


def msm_sharded(table, scalars: torch.Tensor, c: int = 8, group=None):
    """sum_i s_i P_i over every rank's chunk: `table` is `affine_table` of
    this rank's points, `scalars` their (n, 8) standard-form words on the
    same device. Every rank returns the same affine int point (or None)."""
    totals, weights = gather_rows(*local_rows(table, scalars, c), group)
    return msm_ops.combine_rows_host(totals.unbind(1), weights, c)


def msm_sharded_ints(points, scalars, c: int = 8, device="cuda", group=None):
    """Host ints in and out, the counterpart of the reference's
    `msm_sharded_host`: every rank passes the whole lists and takes its
    chunk; no padding."""
    if len(points) != len(scalars):
        raise ValueError(f"{len(points)} points but {len(scalars)} scalars")
    dev = dv.resolve(device)
    lo, hi = my_chunk(len(points), group)
    return msm_sharded(msm_ops.ints_table(points[lo:hi], dev),
                       msm_ops.ints_words(scalars[lo:hi], dev), c, group)
