# Copy of halo2_snark_aggregator_tpu/solidity/chips.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""Codegen context chips: the arith API instantiated to EMIT EVM IR.

Fourth context of the family (reference D1, -solidity/src/chips/*): every
field/curve op both computes a sample value (so the protocol replay drives
control flow and the final pairing can be sanity-checked host-side, like the
reference's debug pairing at lib.rs:269-284) and records an IR statement.
Constant-constant ops fold at trace time (scalar_chip.rs:46-56, 160-172).
"""

from __future__ import annotations

import dataclasses

from ..arith.api import EccChip, FieldChip
from ..ff import bn254 as ff
from .ir import CodegenContext, Expr


@dataclasses.dataclass
class SolValue:
    expr: Expr
    v: int

    @property
    def is_const(self) -> bool:
        return self.expr.kind == "const"


@dataclasses.dataclass
class SolPoint:
    x: Expr
    y: Expr
    v: object  # affine tuple or None (encoded (0,0): EVM precompile identity)

    @property
    def is_const(self) -> bool:
        return self.x.kind == "const" and self.y.kind == "const"


class SolidityFieldChip(FieldChip):
    def __init__(self, cg: CodegenContext):
        self.cg = cg

    def assign_const(self, ctx, v: int) -> SolValue:
        return SolValue(self.cg.const(v % ff.R), v % ff.R)

    def assign_var(self, ctx, v: int) -> SolValue:
        # bare witnesses outside the transcript/instance should not occur in
        # the verifier; surface as constants (mirrors mock chip semantics)
        return self.assign_const(ctx, v)

    def to_value(self, a: SolValue) -> int:
        return a.v

    def _bin(self, op: str, a: SolValue, b: SolValue, fold) -> SolValue:
        value = fold(a.v, b.v) % ff.R
        if a.is_const and b.is_const:
            return SolValue(self.cg.const(value), value)
        return SolValue(self.cg.emit(op, (a.expr, b.expr)), value)

    def add(self, ctx, a, b):
        return self._bin("fr_add", a, b, lambda x, y: x + y)

    def sub(self, ctx, a, b):
        return self._bin("fr_sub", a, b, lambda x, y: x - y)

    def neg(self, ctx, a):
        return self.sub(ctx, self.assign_const(ctx, 0), a)

    def mul(self, ctx, a, b):
        return self._bin("fr_mul", a, b, lambda x, y: x * y)

    def div(self, ctx, a, b):
        return self._bin("fr_div", a, b, lambda x, y: x * pow(y, -1, ff.R))

    def sum_with_coeff_and_constant(self, ctx, pairs, constant):
        acc = self.assign_const(ctx, constant)
        for v, c in pairs:
            term = self.mul(ctx, v, self.assign_const(ctx, c))
            acc = self.add(ctx, acc, term)
        return acc


class SolidityEccChip(EccChip):
    def __init__(self, cg: CodegenContext):
        self.cg = cg
        self.scalar_chip = SolidityFieldChip(cg)
        self.native_chip = self.scalar_chip

    def _const_point(self, pt) -> SolPoint:
        x, y = (0, 0) if pt is None else pt
        return SolPoint(self.cg.const(x), self.cg.const(y), pt)

    def assign_const(self, ctx, pt) -> SolPoint:
        return self._const_point(pt)

    def assign_var(self, ctx, pt) -> SolPoint:
        return self._const_point(pt)

    def assign_zero(self, ctx) -> SolPoint:
        return self._const_point(None)

    def assign_one(self, ctx) -> SolPoint:
        return self._const_point(ff.G1_GEN)

    def to_value(self, p: SolPoint):
        return p.v

    def add(self, ctx, p1: SolPoint, p2: SolPoint) -> SolPoint:
        value = ff.g1_add(p1.v, p2.v)
        x, y = self.cg.emit("ecc_add", (p1.x, p1.y, p2.x, p2.y), out_words=2)
        return SolPoint(x, y, value)

    def sub(self, ctx, p1, p2):
        return self.add(ctx, p1, self.neg(ctx, p2))

    def neg(self, ctx, p: SolPoint) -> SolPoint:
        value = ff.g1_neg(p.v)
        if p.is_const:
            return self._const_point(value)
        x, y = self.cg.emit("ecc_neg", (p.x, p.y), out_words=2)
        return SolPoint(x, y, value)

    def scalar_mul(self, ctx, s: SolValue, p: SolPoint) -> SolPoint:
        value = ff.g1_mul(p.v, s.v)
        x, y = self.cg.emit("ecc_mul", (p.x, p.y, s.expr), out_words=2)
        return SolPoint(x, y, value)

    def scalar_mul_constant(self, ctx, s: SolValue, const_pt) -> SolPoint:
        return self.scalar_mul(ctx, s, self._const_point(const_pt))

    def multi_exp(self, ctx, points, scalars, names=None):
        acc = None
        for p, s in zip(points, scalars):
            t = self.scalar_mul(ctx, s, p)
            acc = t if acc is None else self.add(ctx, acc, t)
        return acc if acc is not None else self.assign_zero(ctx)

    def coords_in_native(self, ctx, nchip, p: SolPoint):
        # used by the Poseidon transcript only; the EVM flavor absorbs via
        # hash_point side effects, but keep this for completeness
        x, y = (0, 0) if p.v is None else p.v
        return (
            SolValue(p.x, x % ff.R),
            SolValue(p.y, y % ff.R),
        )
