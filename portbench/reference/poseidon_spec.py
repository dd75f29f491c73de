# Frozen copy of halo2_snark_aggregator_tpu_torch/hashes/poseidon_spec.py for the benchmark's
# plain reference: imports rewritten to this folder, the native (C++)
# fast paths removed. It imports nothing of the program under test.
"""Poseidon parameter generation (Grain LFSR) for BN254 Fr.

The reference aggregator (hash/poseidon.rs) takes its round constants and MDS
matrix from the PSE `poseidon` crate v0.2.0 (git 0b9965fb), which follows the
Poseidon paper's reference Sage script `generate_parameters_grain.sage`:

  * 80-bit Grain LFSR seeded with (field_tag=1 [2b], sbox_tag=0 [4b],
    n=F::NUM_BITS [12b], t [12b], R_F [10b], R_P [10b], 30 ones), all fields
    MSB-first; recurrence b_i = b_{i-18}^b_{i-29}^b_{i-42}^b_{i-57}^b_{i-67}
    ^b_{i-80}; first 160 bits discarded; output bits taken in pairs (emit the
    second bit of a pair iff the first is 1).
  * (R_F + R_P) rows of T round constants, each sampled as n MSB-first bits
    with rejection (resample when >= modulus).
  * MDS: two vectors xs, ys of T elements each, sampled WITHOUT rejection
    (n bits loaded LSB-first into a 64-byte wide reduction), then the Cauchy
    matrix mds[i][j] = (xs[i] + ys[j])^-1.

NOTE ON PARITY: the PSE crate is a git dependency of the reference and is not
vendored with it, so its exact output is not cross-checked here. This module
implements the published specification the crate follows. All transcript
parity inside this framework (prover <-> verifier <-> aggregation circuit) is
self-consistent through this single module.

The reference instantiates T=9, RATE=8, R_F=8, R_P=63
(circuit/src/verify_circuit.rs:436-449).
"""

from __future__ import annotations

import functools

from .bn254 import R as FR_MOD

FR_NUM_BITS = 254

# Reference parameters (verify_circuit.rs:436-449)
T = 9
RATE = 8
R_F = 8
R_P = 63


class Grain:
    """Grain LFSR bit stream per the Poseidon reference script."""

    def __init__(self, n_bits: int, t: int, r_f: int, r_p: int):
        bits: list[int] = []
        for value, width in ((1, 2), (0, 4), (n_bits, 12), (t, 12), (r_f, 10), (r_p, 10)):
            bits.extend(int(b) for b in format(value, f"0{width}b"))
        bits.extend([1] * 30)
        assert len(bits) == 80
        self.state = bits
        for _ in range(160):
            self._update()

    def _update(self) -> int:
        s = self.state
        new_bit = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        s.pop(0)
        s.append(new_bit)
        return new_bit

    def next_bit(self) -> int:
        """Pair-sampled output bit."""
        while True:
            first = self._update()
            second = self._update()
            if first:
                return second

    def next_field_element(self, modulus: int, n_bits: int) -> int:
        """MSB-first n-bit sample with rejection (round constants)."""
        while True:
            v = 0
            for _ in range(n_bits):
                v = (v << 1) | self.next_bit()
            if v < modulus:
                return v

    def next_field_element_without_rejection(self, modulus: int, n_bits: int) -> int:
        """LSB-first n-bit sample, wide-reduced (MDS vectors)."""
        v = 0
        for i in range(n_bits):
            v |= self.next_bit() << i
        return v % modulus


@functools.lru_cache(maxsize=None)
def generate_constants(
    t: int = T, r_f: int = R_F, r_p: int = R_P,
    modulus: int = FR_MOD, n_bits: int = FR_NUM_BITS,
):
    """Returns (round_constants, mds): (r_f+r_p) rows of t constants, and the
    t x t Cauchy MDS matrix, as plain ints mod `modulus`."""
    grain = Grain(n_bits, t, r_f, r_p)
    round_constants = [
        [grain.next_field_element(modulus, n_bits) for _ in range(t)]
        for _ in range(r_f + r_p)
    ]
    while True:
        vals = [
            grain.next_field_element_without_rejection(modulus, n_bits)
            for _ in range(2 * t)
        ]
        xs, ys = vals[:t], vals[t:]
        if len(set(vals)) != 2 * t:
            continue
        if any((x + y) % modulus == 0 for x in xs for y in ys):
            continue
        break
    mds = [[pow(xs[i] + ys[j], -1, modulus) for j in range(t)] for i in range(t)]
    return round_constants, mds


def permute(state: list[int], modulus: int = FR_MOD, t: int = T,
            r_f: int = R_F, r_p: int = R_P) -> list[int]:
    """Poseidon permutation (`permute_py`)."""
    return permute_py(state, modulus, t, r_f, r_p)


def permute_py(state: list[int], modulus: int = FR_MOD, t: int = T,
               r_f: int = R_F, r_p: int = R_P) -> list[int]:
    """Standard (unoptimized) Poseidon permutation, pure-Python oracle.

    Bit-identical to the optimized start/partial/end schedule the reference
    runs (hash/poseidon.rs:193-230): the PSE `Spec` derives its optimized
    constants from these by constant folding, which preserves the permutation
    as a function.
    """
    rc, mds = generate_constants(t, r_f, r_p, modulus)
    assert len(state) == t
    s = [x % modulus for x in state]
    half_f = r_f // 2
    round_idx = 0

    def sbox(x: int) -> int:
        x2 = x * x % modulus
        x4 = x2 * x2 % modulus
        return x4 * x % modulus

    def apply_mds(vec):
        return [
            sum(mds[i][j] * vec[j] for j in range(t)) % modulus
            for i in range(t)
        ]

    for _ in range(half_f):
        s = [sbox((x + c) % modulus) for x, c in zip(s, rc[round_idx])]
        s = apply_mds(s)
        round_idx += 1
    for _ in range(r_p):
        s = [(x + c) % modulus for x, c in zip(s, rc[round_idx])]
        s[0] = sbox(s[0])
        s = apply_mds(s)
        round_idx += 1
    for _ in range(half_f):
        s = [sbox((x + c) % modulus) for x, c in zip(s, rc[round_idx])]
        s = apply_mds(s)
        round_idx += 1
    return s
