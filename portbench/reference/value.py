# Frozen copy of halo2_snark_aggregator_tpu_torch/arith/value.py for the benchmark's
# plain reference: imports rewritten to this folder, the native (C++)
# fast paths removed. It imports nothing of the program under test.
"""Value context: exact host arithmetic chips (the reference's mock backend).

AssignedValue = python int (mod Fr); AssignedPoint = affine tuple | None.
`ValueContext` records MSM sizes and op counts for profiling, playing the role
of MockChipCtx's point_list (mock/arith/ecc.rs:104-125) feeding
print_points_profiling (evaluation.rs:137-175).
"""

from __future__ import annotations

from . import bn254 as ff
from .api import EccChip, FieldChip


class ValueContext:
    def __init__(self):
        self.field_ops = 0
        self.point_ops = 0
        self.msm_sizes: list[int] = []
        self.point_list: list[str] = []
        self.tag = ""

    def __repr__(self):
        return (
            f"ValueContext(field_ops={self.field_ops}, point_ops={self.point_ops}, "
            f"msms={self.msm_sizes})"
        )


class ValueFieldChip(FieldChip):
    def __init__(self, modulus: int = ff.R):
        self.modulus = modulus

    def assign_const(self, ctx, v): return v % self.modulus
    def assign_var(self, ctx, v): return v % self.modulus
    def to_value(self, a): return a

    def add(self, ctx, a, b):
        ctx.field_ops += 1
        return (a + b) % self.modulus

    def sub(self, ctx, a, b):
        ctx.field_ops += 1
        return (a - b) % self.modulus

    def neg(self, ctx, a):
        return (-a) % self.modulus

    def mul(self, ctx, a, b):
        ctx.field_ops += 1
        return a * b % self.modulus

    def div(self, ctx, a, b):
        ctx.field_ops += 1
        return a * pow(b, -1, self.modulus) % self.modulus

    def sum_with_coeff_and_constant(self, ctx, pairs, constant):
        ctx.field_ops += 1
        acc = constant
        for v, c in pairs:
            acc += v * c
        return acc % self.modulus

    def poseidon_permute(self, ctx, state, inputs):
        """Fused sponge round (PoseidonChipSponge fast path): absorb inputs
        into state[1..], pad marker, one permutation — same schedule as the
        generic per-op path (reference hash/poseidon.rs:193-230)."""
        from .poseidon_spec import RATE, permute

        s = list(state)
        for i, v in enumerate(inputs):
            s[1 + i] = (s[1 + i] + v) % self.modulus
        if len(inputs) < RATE:
            s[1 + len(inputs)] = (s[1 + len(inputs)] + 1) % self.modulus
        ctx.field_ops += 1
        return permute(s, self.modulus)


class ValueEccChip(EccChip):
    def __init__(self):
        self.scalar_chip = ValueFieldChip()
        self.native_chip = self.scalar_chip

    def assign_const(self, ctx, pt): return pt
    def assign_var(self, ctx, pt): return pt
    def assign_zero(self, ctx): return None
    def assign_one(self, ctx): return ff.G1_GEN
    def to_value(self, p): return p

    def add(self, ctx, p1, p2):
        ctx.point_ops += 1
        return ff.g1_add(p1, p2)

    def sub(self, ctx, p1, p2):
        ctx.point_ops += 1
        return ff.g1_add(p1, ff.g1_neg(p2))

    def neg(self, ctx, p):
        return ff.g1_neg(p)

    def scalar_mul(self, ctx, scalar, p):
        ctx.point_ops += 1
        return ff.g1_mul(p, scalar)

    def scalar_mul_constant(self, ctx, scalar, const_pt):
        ctx.point_ops += 1
        return ff.g1_mul(const_pt, scalar)

    def multi_exp(self, ctx, points, scalars, names=None):
        ctx.msm_sizes.append(len(points))
        if names:
            ctx.point_list.extend(names)
        return ff.g1_msm(points, scalars)

    def coords_in_native(self, ctx, nchip, p):
        x, y = (0, 0) if p is None else p
        return (
            nchip.assign_var(ctx, x % ff.R),
            nchip.assign_var(ctx, y % ff.R),
        )
