"""Pippenger MSM over BN254 G1: the host bucket planner, the wrappers of the
accumulate and reduce kernels (csrc/msm.cu) with their plain twins, and the
host window combine.

Flow (the batched verifier's phase B2): `host_bucket_plan` sorts each
window's digits into buckets (order / starts / counts); the accumulate
kernel sums every (window, bucket) lane's points with the mixed add; the
reduce kernel turns each window's buckets into sum_b b * S_b by a parallel
suffix-sum scan (one block per window); the host
combines the windows with one native Pippenger call.

The planner is a copy of the reference's numpy planner
(halo2_snark_aggregator_tpu/ops/msm.py), which sits in a module that
imports jax; tests/test_torch_msm.py holds the copy array-equal to it.
Only unsigned plans are ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ff import bn254 as ff

from ..kernels import build
from . import curve as cv
from . import field as fo

LIMB_BITS = 16
LIMBS = 16
NBITS = 256


# -- host planner (copied from the reference) ----------------------------------


def scalar_digits(scalars: np.ndarray, c: int) -> np.ndarray:
    """uint32[N, 16] 16-bit limbs -> int32[W, N] window digits (width c)."""
    windows = (NBITS + c - 1) // c
    digs = []
    for w in range(windows):
        lo_bit = w * c
        limb = lo_bit // LIMB_BITS
        off = lo_bit % LIMB_BITS
        v = scalars[:, limb] >> off
        if off + c > LIMB_BITS and limb + 1 < LIMBS:
            v = v | (scalars[:, limb + 1] << (LIMB_BITS - off))
        digs.append(v & ((1 << c) - 1))
    return np.stack(digs).astype(np.int32)


def host_bucket_plan(scalars_np: np.ndarray, c: int):
    """Unsigned bucket plan: (order int32[W, N], starts int32[W, 2^c],
    counts int32[W, 2^c]). Window w's bucket b holds the points
    order[w, starts[w, b] : starts[w, b] + counts[w, b]]; bucket 0 (digit 0)
    is dropped (count 0)."""
    n = scalars_np.shape[0]
    windows = (NBITS + c - 1) // c
    mask = (1 << c) - 1
    if c == 8:
        # digit w IS byte w of the scalar
        digits = np.ascontiguousarray(
            scalars_np.astype(np.uint16, order="C").view(np.uint8).T
        ).astype(np.int64)
    else:
        digits = np.zeros((windows, n), dtype=np.int64)
        vals = scalars_np.astype(np.int64)
        for w in range(windows):
            lo_bit = w * c
            limb = lo_bit // LIMB_BITS
            off = lo_bit % LIMB_BITS
            v = vals[:, limb] >> off
            if off + c > LIMB_BITS and limb + 1 < LIMBS:
                v = v | (vals[:, limb + 1] << (LIMB_BITS - off))
            digits[w] = v & mask
    nbuckets = 1 << c
    assert c <= 14, "digit must fit int16 for the radix argsort"
    small = digits.astype(np.uint8 if digits.max(initial=0) < 256
                          else np.uint16)
    order = np.stack([
        np.argsort(small[w], kind="stable") for w in range(windows)
    ]).astype(np.int32)
    sorted_digits = np.take_along_axis(digits, order, axis=1)
    bucket_ids = np.arange(nbuckets)
    starts = np.stack([
        np.searchsorted(sorted_digits[w], bucket_ids, side="left")
        for w in range(windows)
    ]).astype(np.int32)
    ends = np.stack([
        np.searchsorted(sorted_digits[w], bucket_ids, side="right")
        for w in range(windows)
    ]).astype(np.int32)
    counts = (ends - starts).astype(np.int32)
    counts[:, 0] = 0  # digit 0 contributes nothing
    return order, starts, counts


def combine_windows_host(totals, c: int):
    """Per-window projective totals (x, y, z), each (W, 8) words -> the
    affine int point sum_w 2^(c w) T_w (or None), one native Pippenger
    call."""
    pts = cv.to_affine_ints(totals)
    entries = [(p, pow(2, c * w, ff.R)) for w, p in enumerate(pts)
               if p is not None]
    if not entries:
        return None
    return ff.g1_msm([p for p, _ in entries], [s for _, s in entries])


# -- tables ---------------------------------------------------------------------


def affine_table(points) -> tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """Projective (x, y, z) words -> the accumulate kernel's affine table
    (x, y, identity): identity is the host mask of the rows with z = 0.
    Every row is checked: z must be 1 (Montgomery) or 0. A projective row
    would corrupt the mixed add silently."""
    px, py, pz = points
    one = fo.const(fo.FQ, 1, pz.device)
    ident = (pz == 0).all(dim=-1)
    if not bool(((pz == one).all(dim=-1) | ident).all()):
        raise ValueError("MSM table rows are projective (z != 1): normalize "
                         "the table to affine first")
    return px.contiguous(), py.contiguous(), ident.cpu().numpy()


# -- accumulate -----------------------------------------------------------------


def _check(t: torch.Tensor, name: str, shape: tuple, device) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != shape:
        raise ValueError(f"{name}: want int32 {shape}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name} must be contiguous on {device}")


def accumulate_plain(tx, ty, order, starts, counts) -> torch.Tensor:
    """The accumulate kernel's semantics in plain PyTorch: step t updates
    only the lanes whose bucket holds more than t points."""
    windows, nbuckets = counts.shape
    n = order.shape[1]
    lanes = windows * nbuckets
    dev = tx.device
    one = fo.const(fo.FQ, 1, dev)
    acc =[torch.zeros(lanes, fo.WORDS, dtype=torch.int32, device=dev),
           one.expand(lanes, fo.WORDS).clone(),
           torch.zeros(lanes, fo.WORDS, dtype=torch.int32, device=dev)]
    cnt = counts.reshape(-1).long()
    st = starts.reshape(-1).long()
    row = torch.arange(lanes, device=dev) // nbuckets
    for t in range(int(cnt.max()) if lanes else 0):
        live = torch.nonzero(cnt > t).squeeze(1)
        idx = order.reshape(-1)[row[live] * n + st[live] + t].long()
        new = cv.mixed_add(tuple(c[live] for c in acc), tx[idx], ty[idx])
        for c, v in zip(acc, new):
            c[live] = v
    return torch.stack(acc, dim=1)


def accumulate(tx: torch.Tensor, ty: torch.Tensor, order: torch.Tensor,
               starts: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Bucket sums: (windows * nbuckets, 3, 8) projective words, lane
    w * nbuckets + b holding window w's bucket b."""
    dev = tx.device
    n = tx.shape[0]
    windows, nbuckets = counts.shape
    _check(tx, "tx", (n, fo.WORDS), dev)
    _check(ty, "ty", (n, fo.WORDS), dev)
    _check(order, "order", (windows, n), dev)
    _check(starts, "starts", (windows, nbuckets), dev)
    _check(counts, "counts", (windows, nbuckets), dev)
    if dev.type == "cpu":
        return accumulate_plain(tx, ty, order, starts, counts)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    acc = torch.empty((windows * nbuckets, 3, fo.WORDS), dtype=torch.int32,
                      device=dev)
    rc = build.library().h2t_msm_accumulate(
        tx.data_ptr(), ty.data_ptr(), order.data_ptr(), starts.data_ptr(),
        counts.data_ptr(), windows, nbuckets, n, acc.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "msm_accumulate")
    build.count_launch("msm_accumulate")
    return acc


# -- reduce ---------------------------------------------------------------------


REDUCE_THREADS = 256  # csrc/msm.cu kReduceThreads


def reduce_shape(nbuckets: int) -> tuple[int, int]:
    """(threads T, positions per thread L) of the reduce's scan over the
    n = nbuckets - 1 positions: L = ceil(n / 256), T = ceil(n / L)."""
    n = max(nbuckets - 1, 1)
    seg = -(-n // REDUCE_THREADS)
    return -(-n // seg), seg


def _identity_h(shape, device) -> torch.Tensor:
    """The identity (0 : 1 : 0) as halves, shape + (3, 16)."""
    ident = torch.zeros(3, 16, dtype=torch.int64, device=device)
    ident[1] = fo.halves(fo.const(fo.FQ, 1, device))[0]
    return ident.expand(*shape, 3, 16)


def _add_h(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """RCB15 Algorithm 7 on (..., 3, 16) halves."""
    return torch.stack(cv.full_add_h(p.unbind(-2), q.unbind(-2)), dim=-2)


def _neg_h(p: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(p[..., 1, :])
    return torch.stack([p[..., 0, :], fo.sub_h(fo.FQ, zero, p[..., 1, :]),
                        p[..., 2, :]], dim=-2)


def reduce_plain(acc: torch.Tensor, windows: int, nbuckets: int):
    """The reduce kernel's semantics in plain PyTorch, the same complete adds
    in the same order (csrc/msm.cu `reduce_kernel`), vectorised over windows
    and threads: positions x_i = S_{i+1} (identity past n = nbuckets - 1),
    thread t owning [tL, tL + L); (1) segment sums top down, (2) suffix scan
    over the threads, (3) each segment's U_i bottom up and their sum, (4)
    tree sum of the threads' totals."""
    nt, seg = reduce_shape(nbuckets)
    n = nbuckets - 1
    x = fo.halves(acc.reshape(windows, nbuckets, 3, fo.WORDS))[:, 1:]
    x = torch.cat([x, _identity_h((windows, nt * seg - n), acc.device)], dim=1)
    x = x.reshape(windows, nt, seg, 3, 16)
    run = x[:, :, seg - 1]
    for m in range(seg - 2, -1, -1):
        run = _add_h(run, x[:, :, m])
    d = 1
    while d < nt:
        run = torch.cat([_add_h(run[:, : nt - d], run[:, d:]), run[:, nt - d :]],
                        dim=1)
        d *= 2
    u = total = run
    for m in range(1, seg):
        u = _add_h(u, _neg_h(x[:, :, m - 1]))
        total = _add_h(total, u)
    total = total.clone()
    d = 1
    while d < nt:
        lo = torch.arange(0, nt - d, 2 * d, device=acc.device)
        total[:, lo] = _add_h(total[:, lo], total[:, lo + d])
        d *= 2
    return fo.words(total[:, 0])


def reduce(acc: torch.Tensor, windows: int, nbuckets: int) -> torch.Tensor:
    """Per-window totals sum_{b>=1} b * S_b: (windows, 3, 8) words."""
    dev = acc.device
    if nbuckets < 1:
        raise ValueError(f"nbuckets must be >= 1, got {nbuckets}")
    _check(acc, "acc", (windows * nbuckets, 3, fo.WORDS), dev)
    if dev.type == "cpu":
        return reduce_plain(acc, windows, nbuckets)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    totals = torch.empty((windows, 3, fo.WORDS), dtype=torch.int32, device=dev)
    rc = build.library().h2t_msm_reduce(
        acc.data_ptr(), windows, nbuckets, *reduce_shape(nbuckets),
        totals.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "msm_reduce")
    build.count_launch("msm_reduce")
    return totals


# -- pipeline -------------------------------------------------------------------


def plan_to_device(plan, device):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in plan)


def msm_totals(table, scalars16: np.ndarray, c: int,
               stats: dict | None = None) -> torch.Tensor:
    """Window totals (W, 3, 8) of sum_i s_i P_i: host plan -> accumulate ->
    reduce. table: `affine_table`'s (x, y, identity) on the device;
    scalars16: uint32[N, 16] standard-form 16-bit limbs. An identity row's
    scalar is taken as zero, so the plan never reads that row (the mixed
    add is incomplete for q = infinity). A `stats` dict receives the plan's
    largest bucket load (`max_load`) and its mixed adds (`adds`)."""
    tx, ty, ident = table
    if len(ident) != len(scalars16):
        raise ValueError("table and scalars differ in length")
    scalars16 = scalars16.copy()
    scalars16[ident] = 0
    plan = host_bucket_plan(scalars16, c)
    if stats is not None:
        stats.update(max_load=int(plan[2].max()), adds=int(plan[2].sum()))
    order, starts, counts = plan_to_device(plan, tx.device)
    acc = accumulate(tx, ty, order, starts, counts)
    return reduce(acc, counts.shape[0], counts.shape[1])
