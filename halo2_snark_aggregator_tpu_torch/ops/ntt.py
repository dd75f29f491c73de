"""Radix-2 NTT over BN254 Fr: the host plan, the batched transform
`ntt_batch` (csrc/ntt.cu's pass kernel, whose last pass of an inverse also
applies the 1/n scale) with its plain twin, and `ntt_auto`, the transform
of one vector.

The reference is halo2_snark_aggregator_tpu/ops/ntt.py (`_plan`, `ntt`,
`ntt_auto`) and ops/ntt_pallas.py (`_butterfly_kernel` run by `_ntt_fused`
over all stages, and `_scale_kernel`). Iterative Cooley-Tukey on (n, 8)
Montgomery Fr words: the bit-reversal permutation, then k butterfly stages
(stage s: blocks of 2 * 2^s rows, lo = u + v * tw_j, hi = u - v * tw_j
with tw_j = w^(j n / 2^(s+1)), j < 2^s), then the inverse's 1/n scale.
Forward maps coefficients to evaluations at omega^i (in order); inverse
maps back. The twiddles of all stages are one table of n - 1 rows (stage s
at rows 2^s - 1 .. 2^(s+1) - 2), built on the device once per (k, inverse)
and cached there (`device_plan`): the last stage's 2^(k-1) powers of w by
doubling through the field kernel, each earlier stage a stride of them,
and the bit reversal as tensor ops. The reference builds the table on the
host (`_plan`, kept as the twin: the two agree word for word). The
reference's XLA-only paths (`ntt_staged`, `rowwise_jit`, the
transpose-chain bit reversal) are not ported.

The stages run in passes (`pass_bounds`): the first loads its rows in
bit-reversed order and runs stages 0 .. r-1 on contiguous tiles of 2^r
rows; a later pass starting at stage s0 runs on the independent
transforms of the rows l + t 2^s0 (fixed l < 2^s0). The twin runs the
same passes over tensor views, so every split can be held to the
reference on the CPU.

On a CUDA tensor the wrappers launch their kernels; on a CPU tensor their
plain twins run (the CPU tests' path). Nothing falls back.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ff.bn254 import R
from ..kernels import build
from ..prover.domain import omega_for_k
from . import field as fo

FR = fo.FR


def _root(k: int, inverse: bool) -> int:
    """w: omega of the 2^k domain, or its inverse."""
    omega = omega_for_k(k)
    return pow(omega, -1, R) if inverse else omega


def _n_inv_words(k: int, inverse: bool):
    """n^-1 as uint32[8] Montgomery words for an inverse, else None."""
    if not inverse:
        return None
    return fo.ints_to_words([FR.to_mont_int(pow(1 << k, -1, R))])[0]


@functools.lru_cache(maxsize=32)
def _plan(k: int, inverse: bool):
    """The host plan, the twin of `device_plan`'s tables: (rev int64[n],
    twiddles uint32[n - 1, 8] Montgomery words, n^-1 as uint32[8]
    Montgomery words or None). Stage s has 2^s powers of w^(n / 2^(s+1)),
    w = omega or omega^-1, at rows 2^s - 1 .. 2^(s+1) - 2."""
    n = 1 << k
    omega = _root(k, inverse)
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(k):
        rev = (rev << 1) | ((idx >> b) & 1)
    pw = []
    length = 2
    while length <= n:
        w_len = pow(omega, n // length, R)
        # power chain directly in Montgomery form: seed with mont(1) = 2^256
        # and multiply by the plain w_len (keeps the 2^256 factor)
        cur = FR.r_mont
        for _ in range(length // 2):
            pw.append(cur)
            cur = cur * w_len % R
        length <<= 1
    return rev, fo.ints_to_words(pw), _n_inv_words(k, inverse)


def device_tables(k: int, inverse: bool, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(rev int64 (n,), twiddles int32 (n - 1, 8)) built on `device`, equal
    to `_plan`'s: the powers w^i, i < n / 2, by doubling (2 (k - 2)
    launches of the field kernel); stage s is every 2^(k-1-s)-th of them
    (w^(j n / 2^(s+1)) = w^(j 2^(k-1-s))); rev[i] is i with its k bits
    reversed."""
    n = 1 << k
    last = fo.mont_powers(FR, _root(k, inverse), n // 2, device)
    tw = torch.cat([last[:: 1 << (k - 1 - s)] for s in range(k)])
    idx = torch.arange(n, dtype=torch.int64, device=device)
    rev = torch.zeros_like(idx)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev, tw


_DEVICE_PLANS: dict = {}


def device_plan(k: int, inverse: bool, device):
    """(rev, twiddles, n^-1 words): `device_tables` on `device` (cached: 2
    MB of twiddles at k = 16, 128 MiB at k = 22) and n^-1 as a host array."""
    key = (k, inverse, str(device))
    if key not in _DEVICE_PLANS:
        _DEVICE_PLANS[key] = (*device_tables(k, inverse, device),
                              _n_inv_words(k, inverse))
    return _DEVICE_PLANS[key]


def _check(t: torch.Tensor, name: str, rows: int) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != (rows, fo.WORDS):
        raise ValueError(f"{name}: want int32 ({rows}, 8), got {t.dtype} "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# -- butterfly stage (the twin's step) ---------------------------------------------


def butterfly_plain(x: torch.Tensor, tw: torch.Tensor, half: int) -> None:
    """One radix-2 stage over the last row axis of x (..., m, 8), in place:
    rows (b 2h + j, b 2h + h + j) become (u + v tw_j, u - v tw_j), h =
    `half`. `tw` broadcasts to (..., m / 2h, h, 8): (h, 8) for one twiddle
    set, or with leading axes for a set per transform."""
    *lead, m, _w = x.shape
    if half < 1 or half & (half - 1) or m % (2 * half):
        raise ValueError(f"half {half} does not divide {m} rows into stages")
    v = x.view(*lead, m // (2 * half), 2, half, fo.WORDS)
    u, w = v[..., 0, :, :], v[..., 1, :, :]
    t = fo.mont_mul(FR, w, tw.expand_as(w))
    lo, hi = fo.add(FR, u, t), fo.sub(FR, u, t)
    v[..., 0, :, :] = lo
    v[..., 1, :, :] = hi


# -- 1/n scale ----------------------------------------------------------------------


def scale_plain(x: torch.Tensor, c_words: np.ndarray) -> torch.Tensor:
    """x (..., 8) times a Montgomery constant c (8 canonical words): x c
    2^-256 mod r, the inverse's last step (on the card, the last pass's
    epilogue)."""
    if x.dtype != torch.int32 or x.shape[-1] != fo.WORDS:
        raise ValueError(f"x: want int32 (..., 8), got {x.dtype} "
                         f"{tuple(x.shape)}")
    c = fo.to_tensor(np.asarray(c_words, np.uint32).reshape(1, fo.WORDS),
                     x.device)
    return fo.mont_mul(FR, x, c.expand_as(x))


# -- the transform ------------------------------------------------------------------

# A pass runs stages [s0, s1) on groups of 2^(s1 - s0) rows in shared memory
# (csrc/ntt.cu); at most PASS_STAGES stages a pass keeps a block's tile at
# 2^10 rows (32 KB).
PASS_STAGES = 10
MAX_K = 27
MAX_BATCH = 65535      # the launch's grid.y


def pass_bounds(k: int, r: int | None = None) -> list[tuple[int, int]]:
    """The stage ranges of the passes: with `r`, pass 1 runs stages 0 .. r-1
    and pass 2 the rest (one pass when r >= k); without it, the kernel's own
    split, ceil(k / PASS_STAGES) passes of near-equal depth (two passes of 8
    at k = 16)."""
    if r is not None:
        if r < 1:
            raise ValueError(f"split r = {r} must be at least 1")
        return [(0, k)] if r >= k else [(0, r), (r, k)]
    count = -(-k // PASS_STAGES)
    sizes = [k // count + (i < k % count) for i in range(count)]
    bounds, s = [], 0
    for size in sizes:
        bounds.append((s, s + size))
        s += size
    return bounds


def _pass_plain(y: torch.Tensor, tw: torch.Tensor, k: int, s0: int,
                s1: int) -> torch.Tensor:
    """Stages s0 .. s1-1 over y (b, n, 8) as the kernel groups them: row i =
    hi 2^s1 + t 2^s0 + l is point t of the transform (hi, l); stage s pairs
    t and t + 2^(s - s0) with twiddle row 2^s - 1 + (t mod 2^(s - s0)) 2^s0
    + l. Returns the new y."""
    b = y.shape[0]
    P, L = 1 << (s1 - s0), 1 << s0
    g = y.view(b, 1 << (k - s1), P, L, fo.WORDS).transpose(2, 3).contiguous()
    lidx = torch.arange(L, device=y.device)
    for s in range(s0, s1):
        half = 1 << (s - s0)
        jj = torch.arange(half, device=y.device)
        rows = (1 << s) - 1 + (jj[None, :] << s0) + lidx[:, None]
        butterfly_plain(g, tw[rows].unsqueeze(1), half)
    return g.transpose(2, 3).reshape(b, 1 << k, fo.WORDS)


def ntt_batch_plain(x: torch.Tensor, k: int, inverse: bool = False,
                    r: int | None = None,
                    coset: torch.Tensor | None = None) -> torch.Tensor:
    """The transform kernel's semantics in plain PyTorch, pass by pass
    (`pass_bounds(k, r)`): the bit-reversed load (times coset[source row]
    when a coset factor is given), the passes, then the inverse's 1/n (the
    kernel's last pass applies it as it stores; each product is canonical,
    so the words agree)."""
    b, n = x.shape[0], 1 << k
    rev, tw, n_inv = device_plan(k, inverse, x.device)
    y = x[:, rev]
    if coset is not None:
        y = fo.mont_mul(FR, y, coset[rev].expand_as(y))
    for s0, s1 in pass_bounds(k, r):
        y = _pass_plain(y, tw, k, s0, s1)
    if inverse:
        y = scale_plain(y, n_inv)
    return y.contiguous()


def ntt_batch(x: torch.Tensor, k: int, inverse: bool = False,
              coset: torch.Tensor | None = None) -> torch.Tensor:
    """b transforms of 2^k points: x (b, 2^k, 8) Montgomery Fr words; returns
    a new (b, 2^k, 8) tensor. Forward: coefficients -> evaluations at
    omega^i, in order; inverse: back, the 1/n scale included. `coset` (2^k,
    8) multiplies each coefficient row first (a coset extension: coset[i] =
    zeta^i gives evaluations at zeta omega^i). On a CUDA tensor: one launch
    a pass (`pass_bounds(k)`, two at 11 <= k <= 20); an inverse's last pass
    multiplies by n^-1 as it stores."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k = {k} outside 1 .. {MAX_K}")
    n = 1 << k
    if x.dtype != torch.int32 or x.dim() != 3 or tuple(x.shape[1:]) != (n, fo.WORDS):
        raise ValueError(f"x: want int32 (b, {n}, 8), got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.shape[0] > MAX_BATCH:
        raise ValueError(f"batch {x.shape[0]} above {MAX_BATCH}")
    if coset is not None:
        _check(coset, "coset", n)
        if coset.device != x.device:
            raise ValueError("x and coset on different devices")
    if x.device.type == "cpu":
        return ntt_batch_plain(x, k, inverse, coset=coset)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b = x.shape[0]
    out = torch.empty_like(x)
    if b == 0:
        return out
    _rev, tw, n_inv = device_plan(k, inverse, x.device)
    lib = build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bounds = pass_bounds(k)
    for i, (s0, s1) in enumerate(bounds):
        # pass 1 reads x in bit-reversed order (and the coset factor);
        # later passes update `out` in place, each block its own rows; an
        # inverse's last pass scales by n^-1 (a cached host array)
        first, last = i == 0, i == len(bounds) - 1
        rc = lib.h2t_ntt_pass(
            x.data_ptr() if first else out.data_ptr(), out.data_ptr(),
            tw.data_ptr(), coset.data_ptr() if first and coset is not None else None,
            n_inv.ctypes.data if last and inverse else None,
            b, k, s0, s1, int(first), stream)
        build.check(rc, "ntt_transform")
        build.count_launch("ntt_transform")
    return out


def ntt_auto(values: torch.Tensor, k: int, inverse: bool = False) -> torch.Tensor:
    """values: (2^k, 8) Montgomery Fr words; returns a new tensor: `ntt_batch`
    of one vector."""
    _check(values, "values", 1 << k)
    return ntt_batch(values.unsqueeze(0), k, inverse)[0]


def ntt_host_ints(vals: list[int], k: int, inverse: bool = False) -> list[int]:
    """Host ints in and out (Montgomery conversion included), on the CPU."""
    x = fo.mont_words(FR, [v % R for v in vals], "cpu")
    return fo.from_mont_words(FR, ntt_auto(x, k, inverse))
