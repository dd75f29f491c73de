"""Accelerated SRS generation: a fixed-base batch scalar multiplication on
the device.

Port of halo2_snark_aggregator_tpu/prover/srs.py (`fixed_base_msm`,
`unsafe_setup_accel`, `_affine_rr_limbs`, `setup_cached_accel`). The basis
[tau^i] G1 comes from the same tau as `ParamsKZG.unsafe_setup` and holds
the same points:

  * the scalars tau^i are built on the device by doubling through the
    field kernel (`tau_powers_words`; the host list `tau_powers` is its
    twin);
  * 8-bit windows over 256-bit scalars give 32 digit positions;
  * a host table T[j][d] = d 2^(8j) G (32 x 256 points) lives on the device;
  * one launch (ops/curve.fixed_base) sums each scalar's 32 table points,
    cutting the digits out of the scalar's words itself (the reference
    selects the points with a one-hot matmul for the TPU's matrix unit and
    sums them in a 5-level tree of jitted add programs, a TPU compile
    limit);
  * the sums are normalised to affine (z = 1) on the device before anything
    reads the table: the MSM kernels take affine rows only.

The cache under the port's `_cache/` (gitignored) is written to a temp file
and moved into place with `os.replace`, so a run killed mid-write leaves
no broken cache.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np
import torch

from .. import device as dv
from ..ff import bn254 as ff
from ..ops import curve as cv
from ..ops import field as fo
from .accel import AccelParams
from .domain import Domain

WINDOW = cv.WINDOW
POSITIONS = cv.POSITIONS  # 32
CACHE_DIR = Path(__file__).resolve().parent.parent / "_cache"


def _host_tables(base=ff.G1_GEN):
    """T[j][d] = d * 2^(8j) * base as affine int points (None = identity)."""
    tables = []
    b = base
    for _ in range(POSITIONS):
        row = [None, b]
        acc = b
        for _ in range(2, 1 << WINDOW):
            acc = ff.g1_add(acc, b)
            row.append(acc)
        tables.append(row)
        for _ in range(WINDOW):
            b = ff.g1_double(b)
    return tables


def g1_table(device) -> torch.Tensor:
    """The generator's digit table T as (POSITIONS * 256, 3, 8) Montgomery
    Fq words, row j * 256 + d."""
    flat = [pt for row in _host_tables() for pt in row]
    return torch.stack(cv.from_affine_ints(flat, device), dim=1)


SEED = b"halo2-snark-aggregator-tpu"


def _tau_for(k: int, seed: bytes) -> int:
    return int.from_bytes(
        hashlib.sha256(seed + k.to_bytes(4, "little")).digest(), "little") % ff.R


def tau_powers(k: int, seed: bytes = SEED) -> list[int]:
    """[tau^i for i < 2^k], the SRS's scalars, on the host (the twin of
    `tau_powers_words`)."""
    tau = _tau_for(k, seed)
    taus = [1] * (1 << k)
    for i in range(1, 1 << k):
        taus[i] = taus[i - 1] * tau % ff.R
    return taus


def tau_powers_words(k: int, device, seed: bytes = SEED) -> torch.Tensor:
    """`tau_powers` as (2^k, 8) int32 standard-form words built on
    `device`: the Montgomery powers by doubling (field kernel), then one
    product by 1. At k = 22 the host list is 4M Python products."""
    mont = fo.mont_powers(fo.FR, _tau_for(k, seed), 1 << k, device)
    one = fo.const(fo.FR, 1, device, mont=False)
    return fo.elementwise(fo.MUL, fo.FR, mont, one.expand_as(mont))


def unsafe_setup_accel(k: int, seed: bytes = SEED,
                       lagrange_prefix: int = 4096, *,
                       device="cuda") -> AccelParams:
    """Device-generated unsafe SRS; same tau and points as
    ParamsKZG.unsafe_setup. Its table is affine on every row."""
    dev = dv.resolve(device)
    tau = _tau_for(k, seed)
    n = 1 << k
    proj = cv.fixed_base(tau_powers_words(k, dev, seed), g1_table(dev))
    g_dev = cv.normalize_affine(proj)

    # Lagrange-basis prefix for (small) instance-column commitments:
    # L_i(tau) = (omega^i / n) (tau^n - 1) / (tau - omega^i)
    dom = Domain(k)
    tau_n = pow(tau, n, ff.R)
    n_inv = pow(n, -1, ff.R)
    g_lagrange = []
    w = 1
    for _ in range(min(n, lagrange_prefix)):
        li = w * n_inv % ff.R * (tau_n - 1) % ff.R * pow(tau - w, -1, ff.R) % ff.R
        g_lagrange.append(ff.g1_mul(ff.G1_GEN, li))
        w = w * dom.omega % ff.R
    return AccelParams(k, g_dev, ff.G2_GEN, ff.g2_mul(ff.G2_GEN, tau),
                       g_lagrange, device=dev)


def _is_affine(g: np.ndarray) -> bool:
    """Every row has z = Montgomery 1, or is the identity (0, 1, 0)."""
    z = g[:, 2]
    one = fo.FQ.one_mont_words
    ident = (g[:, 0] == 0).all(-1) & (g[:, 1] == one).all(-1) & (z == 0).all(-1)
    return bool(((z == one).all(-1) | ident).all())


def _g2_words(pt) -> np.ndarray:
    return fo.ints_to_words([pt[0].c0, pt[0].c1, pt[1].c0, pt[1].c1])


def _g2_point(words: np.ndarray):
    a = fo.words_to_ints(words)
    return (ff.Fq2(a[0], a[1]), ff.Fq2(a[2], a[3]))


def setup_cached_accel(k: int, cache_dir=None, *, device="cuda") -> AccelParams:
    """Disk-cached accelerated SRS (the reference's HALO2_PARAMS_{k}
    analog). The cache holds the affine table as Montgomery words, the
    Lagrange prefix and the G2 points; a table with a projective row is
    refused."""
    dev = dv.resolve(device)
    path = Path(cache_dir or CACHE_DIR) / f"accel_params_k{k}.npz"
    if path.exists():
        with np.load(path) as data:
            g = data["g"]
            lag, lag_inf = data["g_lagrange"], data["g_lagrange_inf"]
            g2, s_g2 = data["g2"], data["s_g2"]
        if not _is_affine(g):
            raise ValueError(f"{path}: SRS table rows are not affine")
        xs = fo.words_to_ints(lag[:, 0])
        ys = fo.words_to_ints(lag[:, 1])
        g_lagrange = [None if inf else (x, y)
                      for x, y, inf in zip(xs, ys, lag_inf)]
        return AccelParams(k, fo.to_tensor(g, dev), _g2_point(g2),
                           _g2_point(s_g2), g_lagrange, device=dev)
    params = unsafe_setup_accel(k, device=dev)
    pts = params.g_lagrange
    lag = np.stack([fo.ints_to_words([0 if p is None else p[0] for p in pts]),
                    fo.ints_to_words([0 if p is None else p[1] for p in pts])],
                   axis=1)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    with open(tmp, "wb") as f:
        np.savez(f, g=fo.to_numpy(params.g_dev), g_lagrange=lag,
                 g_lagrange_inf=np.array([p is None for p in pts]),
                 g2=_g2_words(params.g2), s_g2=_g2_words(params.s_g2))
    os.replace(tmp, path)
    return params
