"""The yardstick of the kernels' roofline shares: the card's peaks and the
work of each kernel, counted from the cell's shapes.

Frozen from the port's bring-up smoke test (chip_smoke.py, its `Bounds`
and constants, as of the port's first benchmark), so that no later change
to the program moves them. The least time the card could take is the
larger of the bytes over the memory rate and the 32-bit integer
multiply-adds (IMADs) over the IMAD rate; a share is that over the
kernel's measured device time.

The peaks are NVIDIA H100 SXM5 (H100 80GB HBM3), at its 700 W power limit:
  * HBM3 3.35 TB/s (NVIDIA's data sheet);
  * IMAD: 132 SMs x 64 32-bit IMAD lanes an SM a clock (compute
    capability 9.0) x 1,980 MHz, the card's highest SM clock. This rate is
    derived from the SM's lanes, not read from a data sheet.
A product is one Montgomery product of 8 x 32-bit words: 64 32x32->64
multiply-adds for a * b and 8 * (1 + 8) for the reduction, each 64-bit
product two 32-bit IMADs: 2 * 64 + (8 + 2 * 64) = 264 IMADs. The same work
is counted whatever implements it.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.bn254 import R as FR_MODULUS

HBM_BYTES_PER_S = 3.35e12
SMS = 132
IMAD_PER_CLOCK_PER_SM = 64
SM_CLOCK_HZ = 1980e6
IMAD_PER_S = SMS * IMAD_PER_CLOCK_PER_SM * SM_CLOCK_HZ
POWER_LIMIT_W = 700.0             # the limit the peaks assume

WORD_BYTES = 32                   # one field element
MONT_MUL_IMAD = 2 * 64 + (8 + 2 * 64)
MIXED_ADD_MULS = 11               # Renes-Costello-Batina 2015, Algorithm 8

# Poseidon over BN254 Fr as the transcript uses it (width 9, rate 8, x^5,
# 8 full and 63 partial rounds)
POSEIDON_T = 9
POSEIDON_R_F = 8
POSEIDON_R_P = 63
SBOX_MULS = 3                     # x^2, x^4, x^5

# The accumulate's yardstick: the bucket method at a fixed window, one
# mixed add a nonzero digit of a scalar in standard form
MSM_WINDOW = 8
MONT_R_INV = pow(1 << 256, -1, FR_MODULUS)


def poseidon_products(t: int = POSEIDON_T, r_f: int = POSEIDON_R_F,
                      r_p: int = POSEIDON_R_P) -> int:
    """Field products of one permutation at its least: a full round has t
    S-boxes and a dense t x t MDS product; a partial round one S-box and a
    sparse matrix (first row and first column: 2t - 1 products), as the
    optimized partial rounds of the PSE Spec the transcript follows
    (reference/poseidon_spec.py) compute them. 2,124 at t = 9."""
    return r_f * (t * SBOX_MULS + t * t) + r_p * (SBOX_MULS + 2 * t - 1)


def nonzero_digits(words: np.ndarray, c: int = MSM_WINDOW) -> int:
    """Nonzero c-bit digits of scalars given as Montgomery words (uint32
    or int32 [n, 8], little-endian: a * 2^256 mod r): the mixed adds the
    bucket method needs to accumulate them. c divides 32."""
    buf = np.ascontiguousarray(words).astype("<u4", copy=False).tobytes()
    std = b"".join((int.from_bytes(buf[i:i + 32], "little") * MONT_R_INV
                    % FR_MODULUS).to_bytes(32, "little")
                   for i in range(0, len(buf), 32))
    limbs = np.frombuffer(std, dtype="<u4")
    count = 0
    for shift in range(0, 32, c):
        count += int(np.count_nonzero((limbs >> np.uint32(shift))
                                      & np.uint32((1 << c) - 1)))
    return count


def least_seconds(imads: float, nbytes: float) -> float:
    return max(imads / IMAD_PER_S, nbytes / HBM_BYTES_PER_S)


def poseidon_chain_seconds(permutations: int, t: int = POSEIDON_T) -> float:
    """Least time of `permutations` permutations (each lane's states read
    and written once)."""
    imads = permutations * poseidon_products(t) * MONT_MUL_IMAD
    nbytes = permutations * 2 * t * WORD_BYTES
    return least_seconds(imads, nbytes)


def accumulate_seconds(adds: int) -> float:
    """Least time of `adds` mixed additions of affine points into
    projective buckets (each affine point's x and y read once)."""
    imads = adds * MIXED_ADD_MULS * MONT_MUL_IMAD
    nbytes = adds * 2 * WORD_BYTES
    return least_seconds(imads, nbytes)


def share(least: float, measured: float) -> float | None:
    """Roofline share in %, or None where nothing was measured."""
    if measured <= 0 or least <= 0:
        return None
    return 100.0 * least / measured
