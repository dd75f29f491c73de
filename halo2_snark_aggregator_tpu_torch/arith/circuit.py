# Copy of halo2_snark_aggregator_tpu/arith/circuit.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""Circuit context: arith chips that EMIT CONSTRAINTS while computing.

The third instantiation of the context family (reference L2 "circuit chips",
halo2-snark-aggregator-circuit/src/chips/*): the same protocol algorithms
(Poseidon sponge, transcript replay, query construction) run unchanged, but
every chip call lays down base-gate rows, producing the aggregation circuit.

`CircuitFieldChip` implements the FieldChip interface over the universal base
gate (scalar_chip.rs:10-127 analog; div -> div_unsafe at :92-99).
`CircuitEccChip` adapts the non-native gadget EccChip to the protocol's
EccChip interface (ecc_chip.rs:14-133: multi_exp -> shamir at :126-133,
scalar_mul -> windowed mul, scalar_mul_constant -> constant_mul); point
encoding for transcript absorption returns the reduced coordinates' native
companions (encode_chip.rs:15-33).
"""

from __future__ import annotations

from ..ff import bn254 as ff
from ..gadgets.base_gate import AssignedCell, BaseGate, Context
from ..gadgets.ecc_chip import AssignedPoint, EccChip as GadgetEccChip
from .api import EccChip, FieldChip


class CircuitFieldChip(FieldChip):
    """FieldChip over base-gate rows. AssignedValue = AssignedCell."""

    def __init__(self, gate: BaseGate):
        self.gate = gate

    def assign_const(self, ctx: Context, v: int) -> AssignedCell:
        return self.gate.assign_constant(ctx, v)

    def assign_var(self, ctx: Context, v: int) -> AssignedCell:
        return self.gate.assign(ctx, v)

    def to_value(self, a: AssignedCell) -> int:
        return int(a)

    def add(self, ctx, a, b):
        return self.gate.add(ctx, a, b)

    def sub(self, ctx, a, b):
        return self.gate.sub(ctx, a, b)

    def neg(self, ctx, a):
        return self.gate.neg(ctx, a)

    def mul(self, ctx, a, b):
        return self.gate.mul(ctx, a, b)

    def div(self, ctx, a, b):
        # div_unsafe: b != 0 is the caller's obligation, matching the
        # reference ScalarChip (scalar_chip.rs:92-99)
        return self.gate.div_unsafe(ctx, a, b)

    def sum_with_coeff_and_constant(self, ctx, pairs, constant):
        return self.gate.sum_with_coeff_and_constant(ctx, list(pairs), constant)

    def mul_add(self, ctx, a, b, c):
        return self.gate.mul_add(ctx, a, b, c)

    def mul_add_constant(self, ctx, a, b, c):
        return self.gate.mul_add_constant(ctx, a, b, c)


class CircuitEccChip(EccChip):
    """EccChip over the non-native gadget chip (reference
    halo2-snark-aggregator-circuit/src/chips/ecc_chip.rs:14-133).

    AssignedPoint = gadget (x, y: AssignedInteger over Fq, z: identity bit).
    """

    def __init__(self, gadget: GadgetEccChip):
        self.gadget = gadget
        self.scalar_chip = CircuitFieldChip(gadget.integer.gate)
        self.native_chip = self.scalar_chip

    def assign_const(self, ctx, pt) -> AssignedPoint:
        return self.gadget.assign_constant_point(ctx, pt)

    def assign_var(self, ctx, pt) -> AssignedPoint:
        return self.gadget.assign_point(ctx, pt)

    def assign_zero(self, ctx) -> AssignedPoint:
        return self.gadget.assign_identity(ctx)

    def assign_one(self, ctx) -> AssignedPoint:
        return self.gadget.assign_constant_point(ctx, ff.G1_GEN)

    def to_value(self, p: AssignedPoint):
        return p.value(self.gadget)

    def add(self, ctx, p1, p2):
        return self.gadget.add(ctx, p1, p2)

    def sub(self, ctx, p1, p2):
        return self.gadget.add(ctx, p1, self.gadget.neg(ctx, p2))

    def neg(self, ctx, p):
        return self.gadget.neg(ctx, p)

    def normalize(self, ctx, p: AssignedPoint) -> AssignedPoint:
        """Reduce coordinates to their canonical limb ranges
        (ecc_chip.rs reduce at 528-581)."""
        integer = self.gadget.integer
        x = integer.reduce(ctx, p.x) if p.x.overflow else p.x
        y = integer.reduce(ctx, p.y) if p.y.overflow else p.y
        return AssignedPoint(x, y, p.z)

    def scalar_mul(self, ctx, scalar, p):
        if p.const_value is not None:
            # constant point: windowed constant tables, no in-circuit doubles
            return self.gadget.constant_mul(ctx, scalar, p.const_value)
        return self.gadget.scalar_mul(ctx, scalar, p)

    def scalar_mul_constant(self, ctx, scalar, const_pt):
        return self.gadget.constant_mul(ctx, scalar, const_pt)

    def multi_exp(self, ctx, points, scalars, names=None):
        if not points:
            return self.assign_zero(ctx)
        return self.gadget.shamir(ctx, points, scalars)

    def coords_in_native(self, ctx, nchip, p: AssignedPoint):
        """(x, y) base coords cast into the native field for transcript
        absorption (encode_chip.rs:15-33): the native companions of the
        REDUCED coordinates."""
        q = self.normalize(ctx, p)
        integer = self.gadget.integer
        return integer.nat(ctx, q.x), integer.nat(ctx, q.y)
