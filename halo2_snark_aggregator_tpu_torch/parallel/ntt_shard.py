"""The four-step (Bailey) NTT sharded over the ranks of a process group.

Port of halo2_snark_aggregator_tpu/parallel/ntt_shard.py (`ntt_sharded`,
`_twiddle_table`, `ntt_sharded_to_host`). A transform of n = n1 n2
points, n1 = 2^k1, n2 = 2^k2, is

    X[k1 + n1 k2] = NTT2_{i2->k2}( w^(i2 k1) NTT1_{i1->k1}(x[i1 n2 + i2]) )

with w the n-th root (omega of k1 + k2, or its inverse), so the only
communication is one all-to-all between two phases of local batched
transforms:

  phase 1: this rank's n2 / world rows i2 of B[i2, i1] = x[i1 n2 + i2]
           (`shard_rows`), each an n1-point transform (`ops/ntt.ntt_batch`,
           the pass kernel, batched), times the twiddles w^(i2 k1) (the
           field kernel, `ops/field.elementwise`);
  all-to-all: each rank sends its k1 chunk j to rank j;
  phase 2: the received (n2, n1 / world) block transposed to this rank's
           n1 / world rows k1, each an n2-point transform.

The result is this rank's rows k1 of R (n1, n2, 8) with X[k1 + n1 k2] =
R[k1, k2], the reference's layout; `ntt_sharded_to_host` reassembles the
in-order vector. An inverse runs inverse transforms in both phases with
the inverse twiddles: their 1/n1 and 1/n2 scales multiply to 1/n.

The twiddle rows are built on the rank's device with field products
(`twiddle_rows`), not by the reference's host loop of n `pow` calls.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ff.bn254 import R
from ..ops import field as fo
from ..ops import ntt as nt
from ..prover.domain import omega_for_k
from . import group as pg

FR = fo.FR

_TWIDDLES: dict = {}


def twiddle_rows(k1: int, k2: int, lo: int, hi: int, inverse: bool,
                 device) -> torch.Tensor:
    """Rows i2 in [lo, hi) of the middle twiddle table: (hi - lo, n1, 8)
    Montgomery words of w^(i2 j), j < n1 (the reference's `_twiddle_table`
    rows). Column 1 is w^lo times the powers of w (`mont_powers`); the
    columns then double: columns [m, 2m) are columns [0, m) times the
    row's t^m, and t^m squares (two field launches a doubling). Cached
    per device."""
    key = (k1, k2, lo, hi, inverse, str(device))
    if key in _TWIDDLES:
        return _TWIDDLES[key]
    n1 = 1 << k1
    w = omega_for_k(k1 + k2)
    if inverse:
        w = pow(w, -1, R)
    rows = hi - lo
    t = fo.elementwise(fo.MUL, FR, fo.mont_powers(FR, w, rows, device),
                       fo.const(FR, pow(w, lo, R), device).expand(rows, fo.WORDS))
    tab = fo.const(FR, 1, device).expand(rows, 1, fo.WORDS)
    m = 1
    while m < n1:
        new = fo.elementwise(fo.MUL, FR, tab,
                             t[:, None, :].expand(rows, m, fo.WORDS))
        tab = torch.cat([tab, new], dim=1)
        if 2 * m < n1:
            t = fo.elementwise(fo.MUL, FR, t, t)
        m *= 2
    tab = tab.contiguous()
    _TWIDDLES[key] = tab
    return tab


def shard_rows(x: torch.Tensor, k1: int, k2: int, rank: int,
               world: int) -> torch.Tensor:
    """Rank's rows of B[i2, i1] = x[i1 n2 + i2] from the whole vector x
    (n, 8): (n2 / world, n1, 8), contiguous."""
    n1, n2 = 1 << k1, 1 << k2
    r2 = n2 // world
    b = x.reshape(n1, n2, fo.WORDS)[:, rank * r2:(rank + 1) * r2]
    return b.transpose(0, 1).contiguous()


def ntt_sharded(b_local: torch.Tensor, k1: int, k2: int, group=None,
                inverse: bool = False) -> torch.Tensor:
    """The four-step transform of n = 2^(k1 + k2) Montgomery Fr points over
    the group: `b_local` is this rank's `shard_rows` (n2 / world, n1, 8);
    returns this rank's rows k1 of R, (n1 / world, n2, 8), X[k1 + n1 k2] =
    R[k1, k2] (an inverse includes the 1/n scale). n1 and n2 must be
    multiples of the world's size."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    n1, n2 = 1 << k1, 1 << k2
    if n1 % world or n2 % world:
        raise ValueError(f"n1 = {n1} and n2 = {n2} must be multiples of the "
                         f"world's {world}")
    r2 = n2 // world
    if tuple(b_local.shape) != (r2, n1, fo.WORDS):
        raise ValueError(f"b_local: want ({r2}, {n1}, 8), got "
                         f"{tuple(b_local.shape)}")
    s1 = nt.ntt_batch(b_local.contiguous(), k1, inverse)
    tw = twiddle_rows(k1, k2, rank * r2, (rank + 1) * r2, inverse,
                      b_local.device)
    s1 = fo.elementwise(fo.MUL, FR, s1, tw)
    parts = pg.all_to_all(list(s1.split(n1 // world, dim=1)), group)
    t = torch.cat(parts).transpose(0, 1).contiguous()  # (n1 / world, n2, 8)
    return nt.ntt_batch(t, k2, inverse)


def ntt_sharded_to_host(r) -> np.ndarray:
    """(n1, n2, limbs) result matrix -> the in-order (n, limbs) vector on the
    host (the reference's function on the port's words)."""
    r = np.asarray(r)
    n1, n2, limbs = r.shape
    return np.transpose(r, (1, 0, 2)).reshape(n1 * n2, limbs)
