# Copy of halo2_snark_aggregator_tpu/gadgets/ecc_chip.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""In-circuit ECC over non-native coordinates (reference B5/B6,
halo2-ecc-circuit-lib/src/chips/{ecc_chip,native_ecc_chip}.rs).

Points are (x, y: AssignedInteger over the wrong field, z: AssignedCell
identity bit) — the reference's AssignedPoint layout (ecc_chip.rs:11-58).
Completeness is obtained with bisec (conditional-select) trees over the
tangent/chord lambda, mirroring the reference's approach (ecc_chip.rs:383-408)
rather than constraint-free formulas: in-circuit, selects are cheap and the
d*W+rem integer muls are the cost driver.

Scalar multiplication uses binary double-and-add over an asserted bit
decomposition (native_ecc_chip.rs:41-135 decomposes via assigned bits with a
recombination row); `scalar_bits` is parametric so gadget tests stay small.
`multi_exp` is the naive fold for now — the windowed `shamir` MSM
(ecc_chip.rs:139-244) lands with the aggregation circuit round.
"""

from __future__ import annotations

import dataclasses

from ..ff import bn254 as ff
from ..ff.bn254 import R
from .base_gate import AssignedCell, BaseGate, Context
from .integer_chip import AssignedInteger, IntegerChip


@dataclasses.dataclass
class AssignedPoint:
    x: AssignedInteger
    y: AssignedInteger
    z: AssignedCell  # identity flag bit
    # host affine value when the point was assigned as a CONSTANT; lets the
    # MSM build its candidate tables as constants instead of in-circuit adds
    const_value: object = None

    def value(self, chip: "EccChip"):
        if int(self.z):
            return None
        W = chip.integer.f.modulus
        return (self.x.value % W, self.y.value % W)


class EccChip:
    def __init__(self, integer_chip: IntegerChip, curve_b: int = ff.G1_B,
                 scalar_bits: int = 254):
        self.integer = integer_chip
        self.curve_b = curve_b
        self.scalar_bits = scalar_bits

    # -- assignment --------------------------------------------------------
    def assign_point(self, ctx: Context, pt) -> AssignedPoint:
        """Witness an affine point with an on-curve check y^2 = x^3 + b
        (ecc_chip.rs:473-500). Identity is (0, 0, z=1)."""
        chip = self.integer
        gate = chip.gate
        if pt is None:
            x = chip.assign_constant(ctx, 0)
            y = chip.assign_constant(ctx, 0)
            z = gate.assign_constant(ctx, 1)
            return AssignedPoint(x, y, z)
        x = chip.assign_w(ctx, pt[0])
        y = chip.assign_w(ctx, pt[1])
        z = gate.assign_constant(ctx, 0)
        y2 = chip.square(ctx, y)
        x3 = chip.mul(ctx, chip.square(ctx, x), x)
        rhs = chip.add(ctx, x3, chip.assign_constant(ctx, self.curve_b))
        chip.assert_equal(ctx, y2, rhs)
        return AssignedPoint(x, y, z)

    def assign_constant_point(self, ctx: Context, pt) -> AssignedPoint:
        chip = self.integer
        gate = chip.gate
        if pt is None:
            return AssignedPoint(
                chip.assign_constant(ctx, 0),
                chip.assign_constant(ctx, 0),
                gate.assign_constant(ctx, 1),
            )
        return AssignedPoint(
            chip.assign_constant(ctx, pt[0]),
            chip.assign_constant(ctx, pt[1]),
            gate.assign_constant(ctx, 0),
            const_value=(pt[0] % chip.f.modulus, pt[1] % chip.f.modulus),
        )

    def assign_identity(self, ctx: Context) -> AssignedPoint:
        return self.assign_constant_point(ctx, None)

    # -- helpers -----------------------------------------------------------
    def bisec_point(self, ctx, cond, a: AssignedPoint, b: AssignedPoint) -> AssignedPoint:
        chip = self.integer
        gate = chip.gate
        return AssignedPoint(
            chip.bisec(ctx, cond, a.x, b.x),
            chip.bisec(ctx, cond, a.y, b.y),
            gate.bisec(ctx, cond, a.z, b.z),
        )

    def _lambda_tangent(self, ctx, p: AssignedPoint) -> AssignedInteger:
        """3x^2 / 2y (y = 0 impossible in the odd-order subgroup)."""
        chip = self.integer
        x2 = chip.square(ctx, p.x)
        three_x2 = chip.add(ctx, chip.add(ctx, x2, x2), x2)
        two_y = chip.add(ctx, p.y, p.y)
        # guard the denominator when p is the identity (y = 0): divide by 1
        one = chip.assign_constant(ctx, 1)
        safe = chip.bisec(ctx, p.z, one, two_y)
        return chip.div_unsafe(ctx, three_x2, safe)

    def add(self, ctx, p1: AssignedPoint, p2: AssignedPoint) -> AssignedPoint:
        """Complete addition via lambda-select (ecc_chip.rs:383-408).

        One shared division: lam = (eq_x ? 3x1^2 : dy) / (eq_x ? 2y1 : dx),
        selecting numerator/denominator BEFORE the division instead of
        computing both the chord and tangent lambdas (halves the dominant
        wrong-field division cost per add)."""
        chip = self.integer
        gate = chip.gate

        dx = chip.sub(ctx, p2.x, p1.x)
        dy = chip.sub(ctx, p2.y, p1.y)
        eq_x = chip.is_zero(ctx, dx)
        eq_y = chip.is_zero(ctx, dy)

        x1sq = chip.square(ctx, p1.x)
        three_x1sq = chip.add(ctx, chip.add(ctx, x1sq, x1sq), x1sq)
        two_y1 = chip.add(ctx, p1.y, p1.y)
        num = chip.bisec(ctx, eq_x, three_x1sq, dy)
        den_raw = chip.bisec(ctx, eq_x, two_y1, dx)
        # guard: when p1 is the identity (y1 = 0) and eq_x, divide by 1
        one = chip.assign_constant(ctx, 1)
        is_bad = gate.mul(ctx, eq_x, p1.z)
        den = chip.bisec(ctx, is_bad, one, den_raw)
        lam = chip.div_unsafe(ctx, num, den)

        x3 = chip.sub(ctx, chip.sub(ctx, chip.square(ctx, lam), p1.x), p2.x)
        y3 = chip.sub(ctx, chip.mul(ctx, lam, chip.sub(ctx, p1.x, x3)), p1.y)

        # identity outcomes: p1 + (-p1) (eq_x and not eq_y)
        not_eq_y = gate.sum_with_coeff_and_constant(ctx, [(eq_y, R - 1)], 1)
        res_is_id = gate.mul(ctx, eq_x, not_eq_y)
        zero_int = chip.assign_constant(ctx, 0)
        out = AssignedPoint(
            chip.bisec(ctx, res_is_id, zero_int, x3),
            chip.bisec(ctx, res_is_id, zero_int, y3),
            res_is_id,
        )
        # identity inputs
        out = self.bisec_point(ctx, p2.z, p1, out)
        out = self.bisec_point(ctx, p1.z, p2, out)
        return out

    def double(self, ctx, p: AssignedPoint) -> AssignedPoint:
        chip = self.integer
        lam = self._lambda_tangent(ctx, p)
        x3 = chip.sub(ctx, chip.sub(ctx, chip.square(ctx, lam), p.x), p.x)
        y3 = chip.sub(ctx, chip.mul(ctx, lam, chip.sub(ctx, p.x, x3)), p.y)
        zero_int = chip.assign_constant(ctx, 0)
        return AssignedPoint(
            chip.bisec(ctx, p.z, zero_int, x3),
            chip.bisec(ctx, p.z, zero_int, y3),
            p.z,
        )

    def neg(self, ctx, p: AssignedPoint) -> AssignedPoint:
        return AssignedPoint(p.x, self.integer.neg(ctx, p.y), p.z)

    # -- scalar decomposition (native_ecc_chip.rs:41-135) -------------------
    def decompose_scalar(self, ctx, scalar: AssignedCell) -> list[AssignedCell]:
        """Bit decomposition with recombination (native_ecc_chip.rs:41-135).
        The bit witnesses are CREATED inside the dense recombination chain
        (4-5 bits per row, partial sums chained via next_coeff, the scalar
        itself closing the final row), then each bit cell gets one
        booleanness row — ~1.25 rows/bit instead of 2.5."""
        from .base_gate import VAR_COLUMNS
        gate = self.integer.gate
        value = int(scalar) % R
        assert value < (1 << self.scalar_bits), "scalar exceeds configured bits"
        bit_vals = [(value >> i) & 1 for i in range(self.scalar_bits)]
        bits: list[AssignedCell] = []
        idx = 0
        acc_cell = None
        acc_val = 0
        n = self.scalar_bits
        while True:
            lead = 0 if acc_cell is None else 1
            cap = VAR_COLUMNS - lead
            row_pairs = [] if acc_cell is None else [(acc_cell, 1)]
            if n - idx <= cap - 1:
                # final row: remaining bits + the scalar itself (coeff -1)
                take = n - idx
                row_pairs += [(bit_vals[idx + j], pow(2, idx + j, R))
                              for j in range(take)]
                row_pairs += [(0, 0)] * (cap - 1 - take)
                row_pairs.append((scalar, R - 1))
                cells = gate.one_line(ctx, row_pairs)
                bits += cells[lead:lead + take]
                break
            take = cap
            row_pairs += [(bit_vals[idx + j], pow(2, idx + j, R))
                          for j in range(take)]
            new_acc = (acc_val + sum(
                bit_vals[idx + j] << (idx + j) for j in range(take))) % R
            cells = gate.one_line(ctx, row_pairs, mul_next=(0, 0, R - 1))
            bits += cells[lead:lead + take]
            acc_cell = AssignedCell(0, ctx.offset, new_acc)
            acc_val = new_acc
            idx += take
        for b in bits:
            gate.assert_bit(ctx, b)
        return bits

    # -- windowed simultaneous MSM (ecc_chip.rs:139-244) --------------------
    WINDOW = 4  # ecc_chip.rs:70

    def _select_candidate(self, ctx, candidates: list[AssignedPoint],
                          bits: list[AssignedCell]) -> AssignedPoint:
        """Binary bisec tree over 2^len(bits) candidates, bits LSB-first
        (the reference's candidate-pick tree, ecc_chip.rs:86-138)."""
        level = candidates
        for b in bits:
            nxt = []
            for j in range(0, len(level), 2):
                nxt.append(self.bisec_point(ctx, b, level[j + 1], level[j]))
            level = nxt
        assert len(level) == 1
        return level[0]

    def shamir(self, ctx, points: list[AssignedPoint],
               scalars: list[AssignedCell]) -> AssignedPoint:
        """Simultaneous windowed MSM: per-point candidate tables
        [O, P, 2P, .., (2^W-1)P], then per 4-bit window (MSB first) W shared
        doubles + one table-select + one add per point (ecc_chip.rs:139-244)."""
        assert len(points) == len(scalars) and points
        w = self.WINDOW
        bits_list = [self.decompose_scalar(ctx, s) for s in scalars]

        tables = []
        for p in points:
            if p.const_value is not None:
                # constant point: the whole candidate table is constant
                cands = [self.assign_constant_point(ctx, self._host_mul(p.const_value, c))
                         for c in range(1 << w)]
            else:
                cands = [self.assign_identity(ctx), p]
                for _ in range(2, 1 << w):
                    cands.append(self.add(ctx, cands[-1], p))
            tables.append(cands)

        rounds = -(-self.scalar_bits // w)
        acc = None
        for r in reversed(range(rounds)):
            if acc is not None:
                for _ in range(w):
                    acc = self.double(ctx, acc)
            for cands, bits in zip(tables, bits_list):
                wbits = bits[r * w : (r + 1) * w]
                sel = self._select_candidate(ctx, cands[: 1 << len(wbits)], wbits)
                if acc is None:
                    acc = sel
                else:
                    acc = self.add(ctx, acc, sel)
        return acc

    def scalar_mul(self, ctx, scalar: AssignedCell, p: AssignedPoint) -> AssignedPoint:
        """Windowed scalar mul = single-point shamir (ecc_chip.rs:86-138)."""
        return self.shamir(ctx, [p], [scalar])

    # host-side curve law over the chip's own field (parametric: the gadget
    # runs over toy curves in tests and BN254 G1 in production)
    def _host_add(self, p1, p2):
        W = self.integer.f.modulus
        if p1 is None:
            return p2
        if p2 is None:
            return p1
        x1, y1 = p1
        x2, y2 = p2
        if x1 == x2:
            if (y1 + y2) % W == 0:
                return None
            lam = 3 * x1 * x1 * pow(2 * y1, -1, W) % W
        else:
            lam = (y2 - y1) * pow(x2 - x1, -1, W) % W
        x3 = (lam * lam - x1 - x2) % W
        return (x3, (lam * (x1 - x3) - y1) % W)

    def _host_mul(self, p, k: int):
        acc = None
        add = p
        while k:
            if k & 1:
                acc = self._host_add(acc, add)
            add = self._host_add(add, add)
            k >>= 1
        return acc

    def constant_mul(self, ctx, scalar: AssignedCell, pt) -> AssignedPoint:
        """scalar * constant point: host-precomputed per-window multiples
        (c * 2^(W*j) * P assigned as constants), no in-circuit doubles
        (ecc_chip.rs:245-279 constant_mul, widened from the reference's 2-bit
        window since constant candidates cost no constraint rows beyond
        assignment)."""
        w = self.WINDOW
        bits = self.decompose_scalar(ctx, scalar)
        rounds = -(-self.scalar_bits // w)
        acc = None
        for j in range(rounds):
            wbits = bits[j * w : (j + 1) * w]
            base = self._host_mul(pt, 1 << (w * j))
            cands = [self.assign_constant_point(ctx, self._host_mul(base, c))
                     for c in range(1 << len(wbits))]
            sel = self._select_candidate(ctx, cands, wbits)
            acc = sel if acc is None else self.add(ctx, acc, sel)
        return acc

    def multi_exp(self, ctx, points: list[AssignedPoint], scalars: list[AssignedCell]) -> AssignedPoint:
        if not points:
            return self.assign_identity(ctx)
        return self.shamir(ctx, points, scalars)

    def assert_equal(self, ctx, p1: AssignedPoint, p2: AssignedPoint):
        gate = self.integer.gate
        self.integer.assert_equal(ctx, p1.x, p2.x)
        self.integer.assert_equal(ctx, p1.y, p2.y)
        gate.assert_equal(ctx, p1.z, p2.z)
