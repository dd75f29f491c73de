# Frozen copy of halo2_snark_aggregator_tpu_torch/prover/domain.py for the benchmark's
# plain reference: imports rewritten to this folder, the native (C++)
# fast paths removed. It imports nothing of the program under test.
"""Evaluation domain and polynomial arithmetic over BN254 Fr (host exact).

Equivalent role to halo2's `EvaluationDomain`. Coefficient-form polynomials
are lists of ints (low degree first); Lagrange-form are value vectors over the
size-n subgroup generated by omega.

The TPU-side NTT (ops/ntt.py) is differentially tested against this module.
"""

from __future__ import annotations

import functools

from .bn254 import FR_ROOT_OF_UNITY, FR_S, R


@functools.lru_cache(maxsize=None)
def omega_for_k(k: int) -> int:
    assert k <= FR_S
    w = FR_ROOT_OF_UNITY
    for _ in range(FR_S - k):
        w = w * w % R
    return w


def bit_reverse_permute(a: list[int]) -> list[int]:
    n = len(a)
    bits = n.bit_length() - 1
    out = [0] * n
    for i in range(n):
        out[int(format(i, f"0{bits}b")[::-1], 2)] = a[i]
    return out


def ntt(values: list[int], omega: int) -> list[int]:
    """In-order iterative radix-2 NTT: coefficients -> evaluations at omega^i.

    Pure Python (`ntt_py`)."""
    return ntt_py(values, omega)


def ntt_py(values: list[int], omega: int) -> list[int]:
    n = len(values)
    assert n & (n - 1) == 0
    a = bit_reverse_permute([v % R for v in values])
    length = 2
    while length <= n:
        w_len = pow(omega, n // length, R)
        for start in range(0, n, length):
            w = 1
            half = length // 2
            for j in range(start, start + half):
                u = a[j]
                v = a[j + half] * w % R
                a[j] = (u + v) % R
                a[j + half] = (u - v) % R
                w = w * w_len % R
        length <<= 1
    return a


def intt(values: list[int], omega: int) -> list[int]:
    n = len(values)
    inv_n = pow(n, -1, R)
    out = ntt(values, pow(omega, -1, R))
    return [x * inv_n % R for x in out]


class Domain:
    def __init__(self, k: int):
        self.k = k
        self.n = 1 << k
        self.omega = omega_for_k(k)
        self.omega_inv = pow(self.omega, -1, R)

    def lagrange_to_coeff(self, values: list[int]) -> list[int]:
        assert len(values) == self.n
        return intt(values, self.omega)

    def coeff_to_lagrange(self, coeffs: list[int]) -> list[int]:
        assert len(coeffs) <= self.n
        return ntt(list(coeffs) + [0] * (self.n - len(coeffs)), self.omega)

    def rotate_omega(self, x: int, at: int) -> int:
        """x * omega^at (at may be negative) — reference verify.rs:153-167."""
        base = self.omega if at >= 0 else self.omega_inv
        return x * pow(base, abs(at), R) % R


# -- coefficient-form helpers ------------------------------------------------

def poly_eval(coeffs: list[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % R
    return acc


def poly_add(a: list[int], b: list[int]) -> list[int]:
    n = max(len(a), len(b))
    return [((a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0)) % R for i in range(n)]


def poly_scale(a: list[int], s: int) -> list[int]:
    return [c * s % R for c in a]


def poly_mul(a: list[int], b: list[int]) -> list[int]:
    """NTT-based product (falls back to schoolbook for tiny inputs)."""
    if not a or not b:
        return []
    out_len = len(a) + len(b) - 1
    if out_len <= 64:
        out = [0] * out_len
        for i, x in enumerate(a):
            if x == 0:
                continue
            for j, y in enumerate(b):
                out[i + j] = (out[i + j] + x * y) % R
        return out
    size = 1 << (out_len - 1).bit_length()
    w = omega_for_k(size.bit_length() - 1)
    fa = ntt(list(a) + [0] * (size - len(a)), w)
    fb = ntt(list(b) + [0] * (size - len(b)), w)
    return intt([x * y % R for x, y in zip(fa, fb)], w)[:out_len]


def poly_divide_vanishing(coeffs: list[int], n: int) -> list[int]:
    """Exact division by X^n - 1. Raises if the remainder is nonzero."""
    q_len = max(len(coeffs) - n, 0)
    q = [0] * q_len
    rem = list(coeffs)
    for i in range(len(coeffs) - 1, n - 1, -1):
        c = rem[i]
        if c == 0:
            continue
        q[i - n] = c
        rem[i] = 0
        rem[i - n] = (rem[i - n] + c) % R
    if any(x % R != 0 for x in rem):
        raise ValueError("polynomial not divisible by X^n - 1")
    return q


def kate_division(coeffs: list[int], z: int) -> list[int]:
    """(p(X) - p(z)) / (X - z) by synthetic division (halo2 kate_division).

    Quotient satisfies q_{d-1} = c_d and q_{i-1} = c_i + z*q_i.
    """
    if len(coeffs) <= 1:
        return []
    q = [0] * (len(coeffs) - 1)
    q[-1] = coeffs[-1] % R
    for i in range(len(coeffs) - 2, 0, -1):
        q[i - 1] = (coeffs[i] + z * q[i]) % R
    return q


def poly_rotate(coeffs: list[int], omega_pow: int) -> list[int]:
    """p(X) -> p(omega_pow * X): coefficient i scaled by omega_pow^i."""
    out = []
    w = 1
    for c in coeffs:
        out.append(c * w % R)
        w = w * omega_pow % R
    return out
