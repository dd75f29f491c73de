"""BN254 G1 on Montgomery Fq words: host conversions, the plain twins of
the complete additions (csrc/curve.cuh), the wrapper of the batched
complete-add kernel (csrc/curve.cu), affine normalisation on the device and
batched decompression.

A point is a tuple (x, y, z) of (..., 8) word tensors, or one (m, 3, 8)
tensor where a kernel takes a batch; the identity is (0 : 1 : 0). The
additions are Renes-Costello-Batina 2015 for a = 0, b3 = 9: Algorithm 7
(projective + projective, complete) and Algorithm 8 (projective + affine,
complete for q != infinity). The twins evaluate the same field expressions
as csrc/curve.cuh; independent products are stacked into one call, which
changes no value (every intermediate is canonical).

`padd` ports halo2_snark_aggregator_tpu/ops/curve_pallas.py `padd_pallas`
(and ops/curve_rr.add on batched projective points). `fixed_base` ports the
sum that the JAX package's prover/srs.fixed_base_msm makes with a tree of
those adds: every scalar's 32 digit points of the SRS's fixed-base table,
summed in one launch (csrc/curve.cu `fixed_base_kernel`). On a CUDA tensor
each wrapper launches its kernel, on a CPU tensor its twin (`padd_plain`,
`fixed_base_plain`) runs.
"""

from __future__ import annotations

import torch

from ..ff import bn254 as ff

from ..kernels import build
from . import field as fo

FQ = fo.FQ


def from_affine_ints(points, device) -> tuple:
    """Host affine int points (None = identity) -> projective (x, y, z)
    Montgomery words, each (n, 8); affine rows have z = 1."""
    xs, ys, zs = [], [], []
    for pt in points:
        if pt is None:
            xs.append(0)
            ys.append(1)
            zs.append(0)
        else:
            xs.append(pt[0])
            ys.append(pt[1])
            zs.append(1)
    return tuple(fo.mont_words(FQ, v, device) for v in (xs, ys, zs))


def to_affine_ints(p) -> list:
    """Projective (x, y, z) words -> host affine int points (None =
    identity), with one modular inverse for the whole batch."""
    xs, ys, zs = (fo.from_mont_words(FQ, c) for c in p)
    nz = [z for z in zs if z != 0]
    inv_of = []
    if nz:
        prefix = [1]
        for z in nz:
            prefix.append(prefix[-1] * z % ff.P)
        inv_all = pow(prefix[-1], -1, ff.P)
        inv_of = [0] * len(nz)
        for i in range(len(nz) - 1, -1, -1):
            inv_of[i] = prefix[i] * inv_all % ff.P
            inv_all = inv_all * nz[i] % ff.P
    out, j = [], 0
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(None)
            continue
        zi = inv_of[j]
        j += 1
        out.append((x * zi % ff.P, y * zi % ff.P))
    return out


# -- plain twins on 16-bit halves ----------------------------------------------


def _wave(fn, *pairs):
    """Apply a binary halves op to several independent pairs in one call."""
    a = torch.stack(torch.broadcast_tensors(*[x for x, _ in pairs]))
    b = torch.stack(torch.broadcast_tensors(*[y for _, y in pairs]))
    a, b = torch.broadcast_tensors(a, b)
    return fn(FQ, a, b).unbind(0)


def _mm(*pairs):
    return _wave(fo.mont_mul_h, *pairs)


def _ad(*pairs):
    return _wave(fo.add_h, *pairs)


def _sb(*pairs):
    return _wave(fo.sub_h, *pairs)


def _times9(a, b):
    """(9a, 9b) by the kernel's doubling chain."""
    a2, b2 = _ad((a, a), (b, b))
    a4, b4 = _ad((a2, a2), (b2, b2))
    a8, b8 = _ad((a4, a4), (b4, b4))
    return _ad((a8, a), (b8, b))


def _finish(t0, t3, t4, y3, z3, t1m):
    """Second product wave shared by Algorithms 7 and 8 (z3 = t1 + b3 t2,
    t1m = t1 - b3 t2)."""
    w = _mm((t4, y3), (t3, t1m), (y3, t0), (t1m, z3), (t0, t3), (z3, t4))
    (x3,) = _sb((w[1], w[0]))
    y3o, z3o = _ad((w[3], w[2]), (w[5], w[4]))
    return x3, y3o, z3o


def full_add_h(p, q):
    """RCB15 Algorithm 7 on halves (csrc/msm.cu `full_add`)."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    s = _ad((x1, y1), (x2, y2), (y1, z1), (y2, z2), (x1, z1), (x2, z2))
    t0, t1, t2, m3, m4, m5 = _mm((x1, x2), (y1, y2), (z1, z2),
                                 (s[0], s[1]), (s[2], s[3]), (s[4], s[5]))
    u01, u12, u02, tt = _ad((t0, t1), (t1, t2), (t0, t2), (t0, t0))
    t3, t4, y3 = _sb((m3, u01), (m4, u12), (m5, u02))
    (t0_3,) = _ad((tt, t0))
    t2b, y3b = _times9(t2, y3)
    (z3,) = _ad((t1, t2b))
    (t1m,) = _sb((t1, t2b))
    return _finish(t0_3, t3, t4, y3b, z3, t1m)


def mixed_add_h(p, qx, qy):
    """RCB15 Algorithm 8 on halves (csrc/msm.cu `mixed_add`), q affine and
    not the identity."""
    x1, y1, z1 = p
    s = _ad((qx, qy), (x1, y1))
    t0, t1, m3, m4, m5 = _mm((x1, qx), (y1, qy), (s[0], s[1]), (qy, z1),
                             (qx, z1))
    u01, t4, y3, tt = _ad((t0, t1), (m4, y1), (m5, x1), (t0, t0))
    (t3,) = _sb((m3, u01))
    (t0_3,) = _ad((tt, t0))
    t2b, y3b = _times9(z1, y3)
    (z3,) = _ad((t1, t2b))
    (t1m,) = _sb((t1, t2b))
    return _finish(t0_3, t3, t4, y3b, z3, t1m)


def full_add(p, q):
    """Word-level RCB15 Algorithm 7 (plain)."""
    out = full_add_h(tuple(fo.halves(c) for c in p),
                     tuple(fo.halves(c) for c in q))
    return tuple(fo.words(c) for c in out)


def mixed_add(p, qx, qy):
    """Word-level RCB15 Algorithm 8 (plain)."""
    out = mixed_add_h(tuple(fo.halves(c) for c in p), fo.halves(qx),
                      fo.halves(qy))
    return tuple(fo.words(c) for c in out)


# -- the batched complete add (csrc/curve.cu) ------------------------------------


def _check_points(t: torch.Tensor, name: str, m: int, device) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != (m, 3, fo.WORDS):
        raise ValueError(f"{name}: want int32 ({m}, 3, 8), got {t.dtype} "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name} must be contiguous on {device}")


def padd_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The padd kernel's semantics in plain PyTorch: (m, 3, 8) + (m, 3, 8)."""
    out = full_add(a.unbind(1), b.unbind(1))
    return torch.stack(out, dim=1)


def padd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Complete G1 add of two (m, 3, 8) projective batches, row by row."""
    m = a.shape[0]
    _check_points(a, "a", m, a.device)
    _check_points(b, "b", m, a.device)
    if a.device.type == "cpu":
        return padd_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    out = torch.empty_like(a)
    rc = build.library().h2t_curve_padd(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m,
        torch.cuda.current_stream(a.device).cuda_stream)
    build.check(rc, "curve_padd")
    build.count_launch("curve_padd")
    return out


# -- the fixed-base sum (csrc/curve.cu) --------------------------------------------

WINDOW = 8                   # bits a digit
POSITIONS = 256 // WINDOW    # 32 digits a scalar


def digit_points(scalars_std: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(32, n, 3, 8): the table row of each scalar's digit at each position
    (byte j of a scalar's standard-form words is position j's digit)."""
    shifts = torch.arange(0, 32, WINDOW, device=table.device)
    digits = ((scalars_std.long() & 0xFFFFFFFF)[..., None] >> shifts) & 0xFF
    rows = digits.reshape(-1, POSITIONS).T
    return table[rows + (torch.arange(POSITIONS, device=table.device)[:, None]
                         << WINDOW)]


def padd_tree(points: torch.Tensor) -> torch.Tensor:
    """(2^h, n, 3, 8) -> (n, 3, 8): the sum over the first axis as the JAX
    package's prover/srs.fixed_base_msm makes it from `digit_points`, one
    `padd` a level (row j plus row j + half). Normalised, it equals
    `fixed_base` of the same scalars."""
    n = points.shape[1]
    while points.shape[0] > 1:
        half = points.shape[0] // 2
        points = padd(points[:half].reshape(-1, 3, 8),
                      points[half:].reshape(-1, 3, 8)).reshape(half, n, 3, 8)
    return points[0]


def _check_fixed_base(scalars_std: torch.Tensor, table: torch.Tensor) -> None:
    if (scalars_std.dtype != torch.int32 or scalars_std.dim() != 2
            or scalars_std.shape[1] != fo.WORDS):
        raise ValueError(f"scalars_std: want int32 (n, 8), got "
                         f"{scalars_std.dtype} {tuple(scalars_std.shape)}")
    if not scalars_std.is_contiguous():
        raise ValueError("scalars_std must be contiguous")
    _check_points(table, "table", POSITIONS << WINDOW, scalars_std.device)


def fixed_base_plain(scalars_std: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The fixed-base kernel's semantics in plain PyTorch: each scalar walks
    its 32 positions in order; its first nonzero digit's row becomes its
    accumulator, each later nonzero digit's row is mixed-added, zero digits
    are skipped (a scalar with none gives the identity)."""
    _check_fixed_base(scalars_std, table)
    shifts = torch.arange(0, 32, WINDOW, device=table.device)
    digits = (((scalars_std.long() & 0xFFFFFFFF)[..., None] >> shifts) & 0xFF
              ).reshape(-1, POSITIONS)
    one = fo.halves(fo.const(FQ, 1, table.device)[0])
    zero = torch.zeros_like(one)
    acc = tuple(c.expand(digits.shape[0], -1) for c in (zero, one, zero))
    started = torch.zeros((digits.shape[0], 1), dtype=torch.bool,
                          device=table.device)
    for j in range(POSITIONS):
        d = digits[:, j]
        rows = table[(j << WINDOW) + d]
        qx, qy = fo.halves(rows[:, 0]), fo.halves(rows[:, 1])
        added = mixed_add_h(acc, qx, qy)
        live = (d != 0)[:, None]
        first = live & ~started
        later = live & started
        acc = tuple(torch.where(later, s, torch.where(first, f, a))
                    for s, f, a in zip(added, (qx, qy, one.expand_as(qx)),
                                       acc))
        started = started | live
    return torch.stack([fo.words(c) for c in acc], dim=1)


def fixed_base(scalars_std: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[s_i G for each scalar] as (n, 3, 8) projective words: scalars_std
    (n, 8) int32 standard-form words (any 256-bit values), table the (32 *
    256, 3, 8) affine digit table T[j][d] = d 2^(8j) G (prover/srs.g1_table).
    On a CUDA tensor one launch, one thread a scalar; on a CPU tensor the
    twin."""
    _check_fixed_base(scalars_std, table)
    if table.device.type == "cpu":
        return fixed_base_plain(scalars_std, table)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    n = scalars_std.shape[0]
    out = torch.empty((n, 3, fo.WORDS), dtype=torch.int32, device=table.device)
    rc = build.library().h2t_fixed_base(
        scalars_std.data_ptr(), table.data_ptr(), out.data_ptr(), n,
        torch.cuda.current_stream(table.device).cuda_stream)
    build.check(rc, "fixed_base")
    build.count_launch("fixed_base")
    return out


def normalize_affine(points: torch.Tensor) -> torch.Tensor:
    """(m, 3, 8) projective -> the same points with z = 1 (Montgomery), and
    the identity as (0, 1, 0), through the field kernel: one Fermat
    inversion per row (z^(p-2), so z = 0 gives 0) and two products."""
    x, y, z = points.unbind(1)
    zinv = fo.elementwise(fo.POW, FQ, z.contiguous(), exponent=ff.P - 2)
    ax = fo.elementwise(fo.MUL, FQ, x.contiguous(), zinv)
    ay = fo.elementwise(fo.MUL, FQ, y.contiguous(), zinv)
    one = fo.const(FQ, 1, points.device).expand_as(z)
    ident = (z == 0).all(dim=-1, keepdim=True)
    zero = torch.zeros_like(ax)
    return torch.stack([torch.where(ident, zero, ax),
                        torch.where(ident, one, ay),
                        torch.where(ident, zero, one)], dim=1)


# -- decompression -------------------------------------------------------------


def decompress_g1_ys(xs_ints: list[int], device) -> list:
    """For each x < p: y = sqrt(x^3 + 3) as a standard int (parity not yet
    adjusted), or None when x^3 + 3 is not a square (x is off the curve).
    y = (x^3+3)^((p+1)/4) through the field kernel's pow mode (p = 3 mod 4),
    then the check y^2 == x^3 + 3."""
    if not xs_ints:
        return []
    def mul(a, b):
        return fo.elementwise(fo.MUL, FQ, a, b)

    x = fo.to_tensor(fo.ints_to_words(xs_ints), device)
    x = mul(x, fo.const(FQ, FQ.r2, device, mont=False))  # to Montgomery
    t = fo.elementwise(fo.ADD, FQ, mul(mul(x, x), x), fo.const(FQ, 3, device))
    y = fo.elementwise(fo.POW, FQ, t, exponent=(ff.P + 1) // 4)
    ok = (mul(y, y) == t).all(dim=-1).cpu().tolist()
    ys = fo.words_to_ints(mul(y, fo.const(FQ, 1, device, mont=False)))
    return [yv if good else None for yv, good in zip(ys, ok)]
