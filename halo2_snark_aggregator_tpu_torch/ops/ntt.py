"""Radix-2 NTT over BN254 Fr: the host plan, the wrappers of the butterfly
and scale kernels (csrc/ntt.cu) with their plain twins, and `ntt_auto`.

The reference is halo2_snark_aggregator_tpu/ops/ntt.py (`_plan`, `ntt`,
`ntt_auto`) and ops/ntt_pallas.py (the two kernels). Iterative
Cooley-Tukey on (n, 8) Montgomery Fr words: a bit-reversal index, then
k butterfly stages (stage s: blocks of 2 * 2^s rows, lo = u + v * tw_j,
hi = u - v * tw_j with tw_j = w^(j n / 2^(s+1)), j < 2^s), then the inverse's
1/n scale. Forward maps coefficients to evaluations at omega^i (in order);
inverse maps back. The twiddles of all stages are one table of n - 1 rows
(stage s at rows 2^s - 1 .. 2^(s+1) - 2), built on the host once per
(k, inverse) and cached on each device. The reference's XLA-only paths
(`ntt_staged`, `rowwise_jit`, the transpose-chain bit reversal) are not
ported: the bit reversal is a plain index with a cached `rev` tensor.

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


@functools.lru_cache(maxsize=32)
def _plan(k: int, inverse: bool):
    """(rev int64[n], twiddles uint32[n - 1, 8] Montgomery words, n^-1 as
    uint32[8] Montgomery words or None). Stage s has 2^s powers of
    w^(n / 2^(s+1)), w = omega or omega^-1, at rows 2^s - 1 .. 2^(s+1) - 2."""
    n = 1 << k
    omega = omega_for_k(k)
    if inverse:
        omega = pow(omega, -1, R)
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
    n_inv = (fo.ints_to_words([FR.to_mont_int(pow(n, -1, R))])[0]
             if inverse else None)
    return rev, fo.ints_to_words(pw), n_inv


_DEVICE_PLANS: dict = {}


def device_plan(k: int, inverse: bool, device):
    """`_plan` with rev and the twiddle table as tensors on `device`
    (cached: 2 MB of twiddles at k = 16)."""
    key = (k, inverse, str(device))
    if key not in _DEVICE_PLANS:
        rev, tw, n_inv = _plan(k, inverse)
        _DEVICE_PLANS[key] = (torch.from_numpy(rev).to(device),
                              fo.to_tensor(tw, device), n_inv)
    return _DEVICE_PLANS[key]


def _check(t: torch.Tensor, name: str, rows: int) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != (rows, fo.WORDS):
        raise ValueError(f"{name}: want int32 ({rows}, 8), got {t.dtype} "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# -- butterfly stage --------------------------------------------------------------


def butterfly_plain(x: torch.Tensor, tw: torch.Tensor, half: int) -> None:
    """The butterfly kernel's semantics in plain PyTorch, in place."""
    n = x.shape[0]
    v = x.view(n // (2 * half), 2, half, fo.WORDS)
    u, w = v[:, 0], v[:, 1]
    t = fo.mont_mul(FR, w, tw.expand_as(w))
    lo, hi = fo.add(FR, u, t), fo.sub(FR, u, t)
    v[:, 0] = lo
    v[:, 1] = hi


def butterfly(x: torch.Tensor, tw: torch.Tensor, half: int) -> None:
    """One radix-2 stage over x (n, 8), in place: rows (b 2h + j, b 2h + h + j)
    become (u + v tw_j, u - v tw_j), h = `half`."""
    n = x.shape[0]
    if half < 1 or half & (half - 1) or n % (2 * half):
        raise ValueError(f"half {half} does not divide n = {n} into stages")
    _check(x, "x", n)
    _check(tw, "tw", half)
    if tw.device != x.device:
        raise ValueError("x and tw on different devices")
    if x.device.type == "cpu":
        butterfly_plain(x, tw, half)
        return
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    rc = build.library().h2t_ntt_butterfly(
        x.data_ptr(), tw.data_ptr(), n, half,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "ntt_butterfly")
    build.count_launch("ntt_butterfly")


# -- 1/n scale ----------------------------------------------------------------------


def scale_plain(x: torch.Tensor, c_words: np.ndarray) -> torch.Tensor:
    """The scale kernel's semantics in plain PyTorch."""
    c = fo.to_tensor(np.asarray(c_words, np.uint32).reshape(1, fo.WORDS),
                     x.device)
    return fo.mont_mul(FR, x, c.expand_as(x))


def scale(x: torch.Tensor, c_words: np.ndarray,
          out: torch.Tensor | None = None) -> torch.Tensor:
    """x * c * 2^-256 mod r for a Montgomery constant c (8 canonical words);
    `out` may be x itself."""
    n = x.shape[0]
    _check(x, "x", n)
    c_words = np.ascontiguousarray(c_words, dtype=np.uint32).reshape(fo.WORDS)
    if out is None:
        out = torch.empty_like(x)
    _check(out, "out", n)
    if out.device != x.device:
        raise ValueError("x and out on different devices")
    if x.device.type == "cpu":
        out.copy_(scale_plain(x, c_words))
        return out
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    rc = build.library().h2t_ntt_scale(
        x.data_ptr(), out.data_ptr(), c_words.ctypes.data, n,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "ntt_scale")
    build.count_launch("ntt_scale")
    return out


# -- the transform ------------------------------------------------------------------


def ntt_auto(values: torch.Tensor, k: int, inverse: bool = False) -> torch.Tensor:
    """values: (2^k, 8) Montgomery Fr words; returns a new tensor. Forward:
    coefficients -> evaluations at omega^i, in order. Inverse: evaluations
    -> coefficients, the 1/n scale included."""
    n = 1 << k
    _check(values, "values", n)
    rev, tw, n_inv = device_plan(k, inverse, values.device)
    x = values[rev]
    for s in range(k):
        half = 1 << s
        butterfly(x, tw[half - 1 : 2 * half - 1], half)
    if inverse:
        scale(x, n_inv, out=x)
    return x


def ntt_host_ints(vals: list[int], k: int, inverse: bool = False) -> list[int]:
    """Host ints in and out (Montgomery conversion included), on the CPU."""
    x = fo.mont_words(FR, [v % R for v in vals], "cpu")
    return fo.from_mont_words(FR, ntt_auto(x, k, inverse))
