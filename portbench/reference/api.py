# Frozen copy of halo2_snark_aggregator_tpu_torch/arith/api.py for the benchmark's
# plain reference: imports rewritten to this folder, the native (C++)
# fast paths removed. It imports nothing of the program under test.
"""Arithmetic context ("chip") interfaces.

The protocol engine (protocol/*) is written once against these interfaces and
instantiated in multiple contexts, mirroring the reference's
ArithCommonChip/ArithFieldChip/ArithEccChip trait family
(halo2-snark-aggregator-api/src/arith/{common,field,ecc}.rs):

  1. value context (arith/value.py)    — exact host ints; the reference's
                                         "mock" chips (mock/arith/*).
  2. jnp context (arith/jnp_chip.py)   — batched JAX arrays; verification
                                         traces to one XLA program per vk,
                                         MSMs dispatch to ops/msm.
  3. circuit context (future rounds)   — emits aggregation-circuit
                                         constraints (reference L1/L2).
  4. codegen context (future rounds)   — emits EVM verifier IR (reference
                                         -solidity crate).

Unlike the Rust traits there is no ctx-threading: Python chips own their
context state. `ctx` remains an explicit argument to keep the call sites
shaped like the reference for easy parity review.
"""

from __future__ import annotations


class FieldChip:
    """Field arithmetic over assigned values (ArithFieldChip, field.rs:7-105)."""

    def assign_const(self, ctx, v): raise NotImplementedError
    def assign_var(self, ctx, v): raise NotImplementedError
    def assign_zero(self, ctx): return self.assign_const(ctx, 0)
    def assign_one(self, ctx): return self.assign_const(ctx, 1)
    def to_value(self, a): raise NotImplementedError

    def add(self, ctx, a, b): raise NotImplementedError
    def sub(self, ctx, a, b): raise NotImplementedError
    def neg(self, ctx, a): raise NotImplementedError
    def mul(self, ctx, a, b): raise NotImplementedError
    def div(self, ctx, a, b): raise NotImplementedError
    def square(self, ctx, a): return self.mul(ctx, a, a)

    def sum_with_coeff_and_constant(self, ctx, pairs, constant):
        raise NotImplementedError

    def sum_with_constant(self, ctx, vals, constant):
        return self.sum_with_coeff_and_constant(ctx, [(v, 1) for v in vals], constant)

    def mul_add_constant(self, ctx, a, b, c):
        t = self.mul(ctx, a, b)
        return self.sum_with_constant(ctx, [t], c)

    def mul_add(self, ctx, a, b, c):
        t = self.mul(ctx, a, b)
        return self.add(ctx, t, c)

    def mul_add_accumulate(self, ctx, vals, b):
        """Horner: acc = 0; acc = acc*b + v — FIRST element gets highest power
        (field.rs:116-130)."""
        acc = self.assign_zero(ctx)
        for v in vals:
            acc = self.mul_add(ctx, acc, b, v)
        return acc

    def pow_constant(self, ctx, base, exponent: int):
        """Square-and-multiply, MSB first (field.rs:132-153)."""
        assert exponent >= 1
        bits = bin(exponent)[2:]
        acc = base
        for bit in bits[1:]:
            acc = self.square(ctx, acc)
            if bit == "1":
                acc = self.mul(ctx, acc, base)
        return acc


class EccChip:
    """Curve arithmetic over assigned points (ArithEccChip, ecc.rs:6-61)."""

    scalar_chip: FieldChip
    native_chip: FieldChip

    def assign_const(self, ctx, pt): raise NotImplementedError
    def assign_var(self, ctx, pt): raise NotImplementedError
    def assign_zero(self, ctx): raise NotImplementedError
    def assign_one(self, ctx): raise NotImplementedError  # generator
    def to_value(self, p): raise NotImplementedError

    def add(self, ctx, p1, p2): raise NotImplementedError
    def sub(self, ctx, p1, p2): raise NotImplementedError
    def neg(self, ctx, p): raise NotImplementedError
    def normalize(self, ctx, p): return p

    def scalar_mul(self, ctx, scalar, p): raise NotImplementedError
    def scalar_mul_constant(self, ctx, scalar, const_pt): raise NotImplementedError

    def multi_exp(self, ctx, points, scalars, names=None):
        """Default naive fold (ecc.rs:38-60); fast contexts override with
        Pippenger / sharded MSM. `names` feeds MSM profiling (mock
        multi_exp point_list, mock/arith/ecc.rs:104-125)."""
        acc = None
        for p, s in zip(points, scalars):
            t = self.scalar_mul(ctx, s, p)
            acc = t if acc is None else self.add(ctx, acc, t)
        if acc is None:
            acc = self.assign_zero(ctx)
        return acc

    def coords_in_native(self, ctx, nchip, p):
        """Point -> (x, y) base coords cast into the native field, for
        transcript absorption (mock/transcript_encode.rs:29-56)."""
        raise NotImplementedError
