"""Pippenger MSM over BN254 G1: the split bucket plan built on the device,
the wrappers of the accumulate and reduce kernels (csrc/msm.cu) with their
plain twins, and the host row combine.

Flow (phase B2 of the batched verifier, every device commit of the
prover, and `msm_ints`, the hybrid chips' MSM over host ints):
`bucket_plan_split` sorts each window's digits into buckets and cuts
every window whose largest bucket holds more than `target` points into
several accumulator rows, so no (row, bucket) lane sums more than `target`
points; the accumulate kernel sums every lane's points with the mixed add;
the reduce kernel turns each row's buckets into sum_b b * S_b by a parallel
suffix-sum scan (one block per row); the host combines the rows, sum_r
2^(c * weights[r]) T_r, with one native Pippenger call.

The plan follows the reference's `host_bucket_plan_split`
(halo2_snark_aggregator_tpu/ops/msm.py) without its power-of-two row
padding. The numpy planners `host_bucket_plan` / `host_bucket_plan_split`
are copies of the reference's (which sit in a module that imports jax),
kept as the oracle the tests hold the device plan against; no device path
calls them. Only unsigned plans are ported.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as dv
from ..ff import bn254 as ff
from ..kernels import build
from . import curve as cv
from . import field as fo

LIMB_BITS = 16
LIMBS = 16
NBITS = 256
ROWS_CAP = 1024  # the reference's H2T_MSM_ROWS_CAP default


def default_target(n: int, c: int) -> int:
    """The reference's row target: about half the uniform bucket load."""
    return max(64, (n >> c) // 2)


# -- the device plan ------------------------------------------------------------


def scalar_digits(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """Standard-form words (N, 8) int32 -> int64 (W, N) window digits of
    width c, W = ceil(256 / c): digit w is bits [w c, w c + c) (at c = 8,
    byte w)."""
    windows = (NBITS + c - 1) // c
    dev = scalars.device
    vals = scalars.long() & 0xFFFFFFFF
    nxt = torch.cat([vals[:, 1:], torch.zeros_like(vals[:, :1])], dim=1)
    lo = torch.arange(windows, device=dev) * c
    word, off = lo // 32, lo % 32
    mask = (1 << c) - 1
    # bits past the word come from the low bits of the next (none past the
    # top word); masked first, so the shift cannot overflow
    v = (vals[:, word] >> off) | ((nxt[:, word] & mask) << (32 - off))
    return (v & mask).t().contiguous()


def bucket_plan_split(scalars: torch.Tensor, c: int, target: int | None = None,
                      rows_cap: int = ROWS_CAP, stats: dict | None = None):
    """The split bucket plan on the scalars' device: (order int32 (W, N),
    starts int32 (R, B), counts int32 (R, B), weights int32 (R,)), B = 2^c.

    order[w] is a stable sort of the points by window w's digit. Row r
    belongs to window weights[r] and reads order[weights[r]]: its bucket b
    holds the points order[weights[r], starts[r, b] : starts[r, b] +
    counts[r, b]]. A window whose largest bucket holds m points gets
    ceil(m / target) rows (at least one), row k taking points [k target,
    (k + 1) target) of every bucket, so no lane holds more than `target`.
    Bucket 0 (digit 0) is dropped. While the rows would exceed
    max(rows_cap, W), `target` doubles. The only host sync reads the W
    largest loads. A `stats` dict receives `max_load` (largest bucket),
    `max_row_load` (the accumulate's depth), `rows`, `adds` (mixed adds)
    and the `target` used."""
    if scalars.dtype != torch.int32 or scalars.dim() != 2 or scalars.shape[1] != fo.WORDS:
        raise ValueError(f"scalars: want int32 (N, {fo.WORDS}), got "
                         f"{scalars.dtype} {tuple(scalars.shape)}")
    if not 1 <= c <= 14:
        raise ValueError(f"window width {c} outside 1..14")
    dev = scalars.device
    n = scalars.shape[0]
    nbuckets = 1 << c
    digits = scalar_digits(scalars, c)
    windows = digits.shape[0]
    _keys, order = torch.sort(digits.to(torch.int16), dim=1, stable=True)
    flat = digits + torch.arange(windows, device=dev)[:, None] * nbuckets
    counts = torch.bincount(flat.reshape(-1), minlength=windows * nbuckets)
    counts = counts.reshape(windows, nbuckets)
    starts = torch.cumsum(counts, dim=1) - counts
    counts[:, 0] = 0  # digit 0 contributes nothing
    maxc, adds = torch.stack([counts.amax(dim=1), counts.sum(dim=1)]).tolist()

    if target is None:
        target = default_target(n, c)
    cap = max(rows_cap, windows)
    while sum(max(1, -(-m // target)) for m in maxc) > cap:
        target *= 2
    nrows = np.array([max(1, -(-m // target)) for m in maxc])
    weights = np.repeat(np.arange(windows), nrows)
    first = np.cumsum(nrows) - nrows
    offset = (np.arange(len(weights)) - first[weights]) * target
    rows = torch.from_numpy(np.stack([weights, offset])).to(dev)
    w_rows, off = rows[0], rows[1][:, None]
    row_starts = (starts[w_rows] + off).to(torch.int32)
    row_counts = (counts[w_rows] - off).clamp(0, target).to(torch.int32)
    if stats is not None:
        stats.update(max_load=max(maxc), max_row_load=min(max(maxc), target),
                     rows=len(weights), adds=sum(adds), target=target)
    return (order.to(torch.int32), row_starts, row_counts,
            w_rows.to(torch.int32))


# -- host planners (the reference's, the tests' oracle) -------------------------


def host_bucket_plan(scalars_np: np.ndarray, c: int):
    """Unsigned bucket plan: (order int32[W, N], starts int32[W, 2^c],
    counts int32[W, 2^c]). Window w's bucket b holds the points
    order[w, starts[w, b] : starts[w, b] + counts[w, b]]; bucket 0 (digit 0)
    is dropped (count 0). scalars_np: uint32[N, 16] 16-bit limbs."""
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


def host_bucket_plan_split(scalars_np: np.ndarray, c: int,
                           target: int | None = None,
                           rows_cap: int = ROWS_CAP):
    """The reference's split plan on the host: (order, starts, counts,
    weights) as `bucket_plan_split` returns them, as numpy arrays (the
    reference's rows before its power-of-two padding)."""
    n = scalars_np.shape[0]
    if target is None:
        target = default_target(n, c)
    base_order, base_starts, base_counts = host_bucket_plan(scalars_np, c)
    windows = base_order.shape[0]
    rows_cap = max(rows_cap, windows)
    maxcs = [int(base_counts[w].max()) if base_counts[w].size else 0
             for w in range(windows)]
    while sum(max(1, -(-m // target)) for m in maxcs) > rows_cap:
        target *= 2
    rows_starts, rows_counts, weights = [], [], []
    for w in range(windows):
        nrows = max(1, -(-maxcs[w] // target))
        b_start = base_starts[w].astype(np.int64)
        b_count = base_counts[w].astype(np.int64)
        for r in range(nrows):
            off = r * target
            cnt = np.clip(b_count - off, 0, target)
            rows_starts.append((b_start + off).astype(np.int32))
            rows_counts.append(cnt.astype(np.int32))
            weights.append(w)
    return (base_order, np.stack(rows_starts), np.stack(rows_counts),
            np.asarray(weights, dtype=np.int32))


# -- tables ---------------------------------------------------------------------


def affine_table(points) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Projective (x, y, z) words -> the accumulate kernel's affine table
    (x, y, identity): identity is the mask of the rows with z = 0, on the
    table's device. Every row is checked: z must be 1 (Montgomery) or 0. A
    projective row would corrupt the mixed add silently."""
    px, py, pz = points
    one = fo.const(fo.FQ, 1, pz.device)
    ident = (pz == 0).all(dim=-1)
    if not bool(((pz == one).all(dim=-1) | ident).all()):
        raise ValueError("MSM table rows are projective (z != 1): normalize "
                         "the table to affine first")
    return px.contiguous(), py.contiguous(), ident


# -- accumulate -----------------------------------------------------------------


def _check(t: torch.Tensor, name: str, shape: tuple, device) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != shape:
        raise ValueError(f"{name}: want int32 {shape}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name} must be contiguous on {device}")


def accumulate_plain(tx, ty, order, starts, counts, weights) -> torch.Tensor:
    """The accumulate kernel's semantics in plain PyTorch: lane r * B + b
    adds the points order[weights[r], starts[r, b] + t] for t < counts[r, b]
    in order of t; step t updates only the lanes that hold more than t
    points."""
    rows, nbuckets = counts.shape
    n = order.shape[1]
    lanes = rows * nbuckets
    dev = tx.device
    one = fo.const(fo.FQ, 1, dev)
    acc = [torch.zeros(lanes, fo.WORDS, dtype=torch.int32, device=dev),
           one.expand(lanes, fo.WORDS).clone(),
           torch.zeros(lanes, fo.WORDS, dtype=torch.int32, device=dev)]
    cnt = counts.reshape(-1).long()
    base = (weights.long()[:, None] * n + starts.long()).reshape(-1)
    flat = order.reshape(-1)
    for t in range(int(cnt.max()) if lanes else 0):
        live = torch.nonzero(cnt > t).squeeze(1)
        idx = flat[base[live] + t].long()
        new = cv.mixed_add(tuple(c[live] for c in acc), tx[idx], ty[idx])
        for c, v in zip(acc, new):
            c[live] = v
    return torch.stack(acc, dim=1)


def _check_plan_bounds(order, starts, counts, weights) -> None:
    """Every read the plan asks of the kernel lies inside `order`: each
    row's window in [0, W), no negative count, and each lane with points
    within [0, N). One host read of five reduced values."""
    if weights.numel() == 0:
        return
    windows, n = order.shape
    live = counts > 0
    w_lo, w_hi, c_lo, s_lo, e_hi = torch.stack([
        weights.amin(), weights.amax(), counts.amin(),
        torch.where(live, starts, 0).amin(),
        torch.where(live, starts + counts, 0).amax(),
    ]).tolist()
    if w_lo < 0 or w_hi >= windows:
        raise ValueError(f"weights: windows {w_lo}..{w_hi} outside the "
                         f"{windows} rows of order")
    if c_lo < 0 or s_lo < 0 or e_hi > n:
        raise ValueError(f"starts/counts: a lane reads [{s_lo}, {e_hi}) "
                         f"(least count {c_lo}) outside the {n} points")


def accumulate(tx: torch.Tensor, ty: torch.Tensor, order: torch.Tensor,
               starts: torch.Tensor, counts: torch.Tensor,
               weights: torch.Tensor) -> torch.Tensor:
    """Bucket sums of a row plan: (rows * nbuckets, 3, 8) projective words,
    lane r * nbuckets + b holding row r's bucket b. The plan's values are
    checked against `order` before the launch (the kernel reads
    order[weights[r], starts[r, b] + t] unchecked)."""
    dev = tx.device
    n = tx.shape[0]
    rows, nbuckets = counts.shape
    _check(tx, "tx", (n, fo.WORDS), dev)
    _check(ty, "ty", (n, fo.WORDS), dev)
    _check(order, "order", (order.shape[0], n), dev)
    _check(starts, "starts", (rows, nbuckets), dev)
    _check(counts, "counts", (rows, nbuckets), dev)
    _check(weights, "weights", (rows,), dev)
    _check_plan_bounds(order, starts, counts, weights)
    if dev.type == "cpu":
        return accumulate_plain(tx, ty, order, starts, counts, weights)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    acc = torch.empty((rows * nbuckets, 3, fo.WORDS), dtype=torch.int32,
                      device=dev)
    rc = build.library().h2t_msm_accumulate(
        tx.data_ptr(), ty.data_ptr(), order.data_ptr(), starts.data_ptr(),
        counts.data_ptr(), weights.data_ptr(), rows, nbuckets, n,
        acc.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
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


def reduce_plain(acc: torch.Tensor, rows: int, nbuckets: int):
    """The reduce kernel's semantics in plain PyTorch, the same complete adds
    in the same order (csrc/msm.cu `reduce_kernel`), vectorised over rows
    and threads: positions x_i = S_{i+1} (identity past n = nbuckets - 1),
    thread t owning [tL, tL + L); (1) segment sums top down, (2) suffix scan
    over the threads, (3) each segment's U_i bottom up and their sum, (4)
    tree sum of the threads' totals."""
    nt, seg = reduce_shape(nbuckets)
    n = nbuckets - 1
    x = fo.halves(acc.reshape(rows, nbuckets, 3, fo.WORDS))[:, 1:]
    x = torch.cat([x, _identity_h((rows, nt * seg - n), acc.device)], dim=1)
    x = x.reshape(rows, nt, seg, 3, 16)
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


def reduce(acc: torch.Tensor, rows: int, nbuckets: int) -> torch.Tensor:
    """Per-row totals sum_{b>=1} b * S_b: (rows, 3, 8) words."""
    dev = acc.device
    if nbuckets < 1:
        raise ValueError(f"nbuckets must be >= 1, got {nbuckets}")
    _check(acc, "acc", (rows * nbuckets, 3, fo.WORDS), dev)
    if dev.type == "cpu":
        return reduce_plain(acc, rows, nbuckets)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    totals = torch.empty((rows, 3, fo.WORDS), dtype=torch.int32, device=dev)
    rc = build.library().h2t_msm_reduce(
        acc.data_ptr(), rows, nbuckets, *reduce_shape(nbuckets),
        totals.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "msm_reduce")
    build.count_launch("msm_reduce")
    return totals


# -- pipeline -------------------------------------------------------------------


def _no_lap(_phase: str) -> None:
    pass


def msm_totals(table, scalars: torch.Tensor, c: int, target: int | None = None,
               rows_cap: int = ROWS_CAP, stats: dict | None = None,
               lap=_no_lap):
    """Row totals of sum_i s_i P_i and the rows' window indices: (totals
    (R, 3, 8) words, weights int32 (R,)), both on the table's device; the
    point is `combine_rows_host(totals.unbind(1), weights, c)`. table:
    `affine_table`'s (x, y, identity); scalars: (N, 8) int32 standard-form
    words on the same device. An identity row's scalar is taken as zero, so
    the plan never reads that row (the mixed add is incomplete for q =
    infinity). `stats` receives the plan's figures (`bucket_plan_split`);
    `lap(phase)` is called as each phase (plan, accumulate, reduce) ends."""
    tx, ty, ident = table
    if scalars.shape[0] != ident.shape[0]:
        raise ValueError("table and scalars differ in length")
    scalars = scalars.masked_fill(ident[:, None], 0)
    order, starts, counts, weights = bucket_plan_split(
        scalars, c, target, rows_cap, stats)
    lap("plan")
    acc = accumulate(tx, ty, order, starts, counts, weights)
    lap("accumulate")
    totals = reduce(acc, counts.shape[0], counts.shape[1])
    lap("reduce")
    return totals, weights


def combine_rows_host(totals, weights, c: int):
    """Row totals (x, y, z), each (R, 8) words, and their windows -> the
    affine int point sum_r 2^(c weights[r]) T_r (or None), one native
    Pippenger call."""
    pts = cv.to_affine_ints(totals)
    ws = weights.tolist() if isinstance(weights, torch.Tensor) else list(weights)
    entries = [(p, pow(2, c * int(w), ff.R)) for p, w in zip(pts, ws)
               if p is not None]
    if not entries:
        return None
    return ff.g1_msm([p for p, _ in entries], [s for _, s in entries])


def ints_table(points, device):
    """`affine_table` of host affine int points (None = identity) on
    `device`; empty for no points."""
    if not points:
        empty = torch.zeros((0, fo.WORDS), dtype=torch.int32, device=device)
        return empty, empty, empty[:, 0].bool()
    return affine_table(cv.from_affine_ints(list(points), device))


def ints_words(scalars, device) -> torch.Tensor:
    """Int scalars, taken mod r, as (n, 8) standard-form words."""
    return fo.to_tensor(fo.ints_to_words([int(s) % ff.R for s in scalars]),
                        device)


def msm_ints(points, scalars, c: int = 8, device="cuda"):
    """sum_i s_i P_i over host affine int points (None = identity) and int
    scalars, on `device`: an affine int point, or None. The counterpart of
    the reference's `msm_host` (ops/msm.py:840) on the split plan: the
    points become the accumulate kernel's affine table (identity rows
    masked, so the mixed add never meets one), the scalars standard-form
    words mod r, then `msm_totals` and the host row combine. No padding:
    the plan and the kernels take any number of points (the reference pads
    to a power of two for its jit shapes)."""
    if len(points) != len(scalars):
        raise ValueError(f"{len(points)} points but {len(scalars)} scalars")
    if not points:
        return None
    dev = dv.resolve(device)
    totals, weights = msm_totals(ints_table(points, dev),
                                 ints_words(scalars, dev), c)
    return combine_rows_host(totals.unbind(1), weights, c)
