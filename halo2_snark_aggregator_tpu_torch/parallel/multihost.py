"""The two-level MSM over a (host, chip) grid of ranks.

Port of halo2_snark_aggregator_tpu/parallel/multihost.py (`msm_hier`,
`msm_hier_host`; `init_distributed` and `make_host_mesh` are
parallel/group.py's `init_group` and `host_groups`). The layout rule of
the reference holds: the heavy gather rides the inner axis (the chips of
one host, NVLink), and one point a host crosses the outer axis.

  1. every rank computes the row totals of its chunk (`msm_shard.local_rows`:
     the split plan, the accumulate and reduce kernels), chunks taken over
     the flattened grid (global rank order);
  2. the rows are all-gathered over the chip group and folded inside the
     host into one point (`combine_rows_host`);
  3. the hosts' points are all-gathered over the host group, one a host,
     and added: every rank returns the same affine point.

A 1-host grid is the plain sharded MSM with one more (one-member) gather.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import device as dv
from ..ff import bn254 as ff
from ..ops import curve as cv
from ..ops import msm as msm_ops
from . import group as pg
from . import msm_shard as ms


def gather_points(point, device, group=None) -> list:
    """Every rank's affine int point (None = identity), in rank order."""
    words = torch.stack(cv.from_affine_ints([point], device), dim=1)
    return cv.to_affine_ints(torch.cat(pg.all_gather(words, group)).unbind(1))


def msm_hier(table, scalars: torch.Tensor, host_group, chip_group,
             c: int = 8):
    """sum_i s_i P_i over the grid: `table` and `scalars` are this rank's
    chunk, as `msm_shard.msm_sharded` takes them; the groups are
    `group.host_groups`'. Every rank returns the same affine int point."""
    totals, weights = ms.gather_rows(*ms.local_rows(table, scalars, c),
                                     chip_group)
    host_point = msm_ops.combine_rows_host(totals.unbind(1), weights, c)
    total = None
    for p in gather_points(host_point, scalars.device, host_group):
        total = ff.g1_add(total, p)
    return total


def msm_hier_ints(points, scalars, host_group, chip_group, c: int = 8,
                  device="cuda"):
    """Host ints in and out, the counterpart of `msm_hier_host`: every rank
    passes the whole lists and takes its chunk of the flattened grid."""
    if len(points) != len(scalars):
        raise ValueError(f"{len(points)} points but {len(scalars)} scalars")
    dev = dv.resolve(device)
    lo, hi = ms.chunk_bounds(len(points), dist.get_rank(),
                             dist.get_world_size())
    return msm_hier(msm_ops.ints_table(points[lo:hi], dev),
                    msm_ops.ints_words(scalars[lo:hi], dev), host_group,
                    chip_group, c)
