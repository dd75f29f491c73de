# Copy of halo2_snark_aggregator_tpu/gadgets/integer_chip.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""Non-native ("wrong field") integer arithmetic in-circuit (reference B4).

Emulates arithmetic mod W (e.g. BN254 Fq) over the native field Fr using
NLIMBS limbs of `limb_bits` bits with redundant (overflowed) limb values and
a lazily-maintained native companion (value mod r) — the same architecture as
five/integer_chip.rs (LIMBS=4 x 68-bit limbs, native companion at 595-621,
d*W+rem mul decomposition at 104-287, reduce at 483-581), with the soundness
argument made explicit:

  a*b - d*W - rem = 0 is enforced (1) mod r via the native companions and
  (2) mod 2^(2*slice_bits*NSLICES... i.e. mod 2^(136*2) for the default
  4-limb shape) via two limb-pair slice checks with signed, range-checked
  carries; CRT over bounds |t| < 2^272 * r / 2 makes the identity exact.

Parameters are explicit so gadget tests can instantiate a small W at small k
while production uses BN254 Fq with 68/17 (the reference's constants).
"""

from __future__ import annotations

import dataclasses

from ..ff.bn254 import P as BN254_FQ, R
from .base_gate import AssignedCell, BaseGate, Context, pair
from .range_gate import RangeGate

NLIMBS = 4


@dataclasses.dataclass(frozen=True)
class WrongField:
    modulus: int
    limb_bits: int

    @property
    def w_ceil_bits(self) -> int:
        return self.modulus.bit_length()

    @property
    def limb_mask(self) -> int:
        return (1 << self.limb_bits) - 1

    def to_limbs(self, v: int) -> list[int]:
        return [(v >> (self.limb_bits * i)) & self.limb_mask for i in range(NLIMBS)]


# production configuration: BN254 Fq over Fr, 4 x 68-bit limbs (17-bit lookups)
FQ_OVER_FR = WrongField(modulus=BN254_FQ, limb_bits=68)


@dataclasses.dataclass
class AssignedInteger:
    """limbs are base-gate cells whose values may exceed limb_bits by
    `overflow` bits (redundant representation); `value` is the exact integer
    sum(limb_i 2^(limb_bits*i)); `native` is value mod r in-circuit.

    `bound_bits` is the static CONSTRAINT-derived bound value < 2^bound_bits
    (tighter than what `overflow` implies: a freshly ranged integer is
    < 2^w_ceil_bits because its top limb is range-checked to the w_ceil
    remainder, not a full limb). It drives the d-witness widths and the CRT
    soundness budget of mul/mul_match — the analog of the reference's
    overflow-counter bound a < overflows*W (five/integer_chip.rs:21-25)."""

    limbs: list[AssignedCell]
    native: AssignedCell
    value: int
    overflow: int  # extra bits beyond limb_bits any limb may carry
    bound_bits: int = 0  # value < 2^bound_bits (0 = derive from overflow)


class IntegerChip:
    # reduce when redundancy exceeds this many extra bits (reference keeps an
    # overflow counter with threshold 32 / limit 64, five/integer_chip.rs:21-25)
    OVERFLOW_BITS_LIMIT = 8

    def __init__(self, gate: BaseGate, rgate: RangeGate, field: WrongField):
        self.gate = gate
        self.rgate = rgate
        self.f = field
        lb = field.limb_bits
        r_native = [pow(2, lb * i, R) for i in range(NLIMBS)]
        self._limb_base = r_native
        self._w_native = field.modulus % R
        self._w_limbs = field.to_limbs(field.modulus)

    # -- assignment --------------------------------------------------------
    def _native_of(self, ctx, limb_cells) -> AssignedCell:
        return self.gate.sum_with_coeff_and_constant(
            ctx, [(c, b) for c, b in zip(limb_cells, self._limb_base)], 0
        )

    def _round_chunk(self, bits: int) -> int:
        """Round a range width up to a whole number of lookup chunks (skips
        the tighten row; callers must have bound slack for the rounding)."""
        t = self.rgate.config.bits
        return -(-bits // t) * t

    def nat(self, ctx, a: AssignedInteger):
        """Materialize the lazy native companion (value mod r) from the
        limbs — the reference's on-demand native (five/integer_chip.rs:
        595-621). Linear ops leave native=None; only mul/reduce/equality
        consumers pay the one recombination row."""
        if a.native is None:
            a.native = self._native_of(ctx, a.limbs)
        return a.native

    def assign_w(self, ctx: Context, v: int) -> AssignedInteger:
        """Witness a value < 2^w_ceil_bits with range-checked limbs."""
        f = self.f
        v %= f.modulus
        limb_vals = f.to_limbs(v)
        cells = []
        for i, lv in enumerate(limb_vals):
            bits = f.limb_bits
            if i == NLIMBS - 1:
                # the top limb stays TIGHT to w_ceil (soundness of the
                # value < 2^w_ceil < 2W bound that is_zero's {0, W}
                # disjunction relies on — the reference's w_ceil-leading
                # lookup family, five/range_gate.rs)
                bits = f.w_ceil_bits - f.limb_bits * (NLIMBS - 1)
            cells.append(self.rgate.assign_ranged(ctx, lv, bits))
        return AssignedInteger(cells, self._native_of(ctx, cells), v, 0,
                               f.w_ceil_bits)

    def _assign_d(self, ctx: Context, d: int, d_bits: int):
        """Witness the d quotient of a d*W+rem decomposition as NLIMBS
        range-checked limbs + native companion. Returns (cells, native,
        limb_values, top_bits)."""
        f = self.f
        lb = f.limb_bits
        d_top_bits = max(d_bits - lb * (NLIMBS - 1), 1)
        d_top = d >> (lb * (NLIMBS - 1))
        d_limbs_v = [(d >> (lb * i)) & f.limb_mask for i in range(NLIMBS - 1)]
        d_limbs_v.append(d_top)
        assert d_top < (1 << d_top_bits), "d exceeds static bound"
        cells = []
        for i in range(NLIMBS):
            bits = lb if i < NLIMBS - 1 else d_top_bits
            cells.append(self.rgate.assign_ranged(ctx, d_limbs_v[i], bits))
        return cells, self._native_of(ctx, cells), d_limbs_v, d_top_bits

    def assign_constant(self, ctx: Context, v: int) -> AssignedInteger:
        f = self.f
        v %= f.modulus
        cells = [self.gate.assign_constant(ctx, lv) for lv in f.to_limbs(v)]
        return AssignedInteger(cells, self._native_of(ctx, cells), v, 0,
                               f.w_ceil_bits)

    # -- linear ops --------------------------------------------------------
    def add(self, ctx, a: AssignedInteger, b: AssignedInteger) -> AssignedInteger:
        limbs = [self.gate.add(ctx, x, y) for x, y in zip(a.limbs, b.limbs)]
        out = AssignedInteger(limbs, None, a.value + b.value,
                              max(a.overflow, b.overflow) + 1,
                              max(self._value_bits(a), self._value_bits(b)) + 1)
        return self._maybe_reduce(ctx, out)

    def _value_bits(self, a: AssignedInteger) -> int:
        """Static bound: a.value < 2^_value_bits(a)."""
        if a.bound_bits:
            return a.bound_bits
        return self.f.limb_bits * NLIMBS + a.overflow + 2

    def _padding_multiple(self, b: AssignedInteger) -> tuple[int, list[int]]:
        """Multiple of W whose greedy limb split dominates any limb of b,
        enabling borrow-free subtraction (depends only on b.overflow, so the
        circuit shape is witness-independent)."""
        f = self.f
        # each b limb < 2^(limb_bits + b.overflow); choose pad limbs >= need
        need = 1 << (f.limb_bits + b.overflow)
        m = (need << (f.limb_bits * (NLIMBS - 1) + 2)) // f.modulus + 1
        pad_val = m * f.modulus
        pad_limbs = []
        rest = pad_val
        for _ in range(NLIMBS - 1):
            limb = (rest & f.limb_mask) + need  # == rest mod 2^lb, >= need
            pad_limbs.append(limb)
            rest = (rest - limb) >> f.limb_bits
        pad_limbs.append(rest)
        assert rest >= need, "padding multiple too small"
        assert sum(pl << (f.limb_bits * i) for i, pl in enumerate(pad_limbs)) == pad_val
        return pad_val, pad_limbs

    def sub(self, ctx, a: AssignedInteger, b: AssignedInteger) -> AssignedInteger:
        """a - b + pad (pad a multiple of W making limbs non-negative;
        five/integer_chip.rs:641-707 w-ceil padding)."""
        pad_val, pad_limbs = self._padding_multiple(b)
        limbs = []
        for x, y, pl in zip(a.limbs, b.limbs, pad_limbs):
            s = self.gate.sum_with_coeff_and_constant(ctx, [(x, 1), (y, R - 1)], pl)
            limbs.append(s)
        value = a.value - b.value + pad_val
        assert value >= 0
        # result limb < 2^(lb + a.ov) + pad_top; pad limbs ~ 2^(lb + b.ov + 3)
        ov_bits = max(a.overflow, b.overflow + 3) + 1
        out = AssignedInteger(limbs, None, value, ov_bits,
                              max(self._value_bits(a), pad_val.bit_length()) + 1)
        return self._maybe_reduce(ctx, out)

    def neg(self, ctx, a: AssignedInteger) -> AssignedInteger:
        zero = self.assign_constant(ctx, 0)
        return self.sub(ctx, zero, a)

    # -- reduction ---------------------------------------------------------
    def _maybe_reduce(self, ctx, a: AssignedInteger) -> AssignedInteger:
        if a.overflow > self.OVERFLOW_BITS_LIMIT:
            return self.reduce(ctx, a)
        return a

    def _crt_budget_reduce(self, ctx, a: AssignedInteger, b: AssignedInteger):
        """CRT soundness guard for mul/mul_match: the slice+native checks are
        exact only while |a*b ± pads| < 2^(4*lb) * r / 2; reduce the fatter
        operand until the static bounds fit the budget."""
        budget = 4 * self.f.limb_bits + R.bit_length() - 4
        assert 2 * self.f.w_ceil_bits <= budget, "field shape breaks CRT budget"
        while self._value_bits(a) + self._value_bits(b) > budget:
            if self._value_bits(a) >= self._value_bits(b):
                a = self.reduce(ctx, a)
            else:
                b = self.reduce(ctx, b)
        return a, b

    def reduce(self, ctx, a: AssignedInteger) -> AssignedInteger:
        """a = d*W + rem with small d; rem freshly range-checked
        (five/integer_chip.rs:483-581). Enforced mod r and mod 2^limb_bits
        with a signed carry (CRT covers the bounded value). Range widths are
        rounded up to whole lookup chunks; the lcm(2^lb, r) budget assert
        keeps the rounding sound."""
        f = self.f
        lb = f.limb_bits
        d = a.value // f.modulus
        rem = a.value % f.modulus
        # static bound: d < a.value / W < 2^(value_bits - w_ceil + 1)
        d_bits = self._round_chunk(max(self._value_bits(a) - f.w_ceil_bits + 1, 1))
        assert d < (1 << d_bits)
        assert max(self._value_bits(a), d_bits + f.w_ceil_bits + 1) < lb + 253, \
            "reduce CRT budget exceeded"
        a_native = self.nat(ctx, a)
        d_cell = self.rgate.assign_ranged(ctx, d, d_bits)
        rem_int = self.assign_w(ctx, rem)

        # native: a.native - d*W - rem.native = 0 (mod r)
        self.gate.one_line(
            ctx,
            [pair(a_native, 1), pair(d_cell, (-self._w_native) % R),
             pair(rem_int.native, R - 1)],
        )

        # low limb: a0 - d*W0 - rem0 = c * 2^limb_bits, c signed bounded
        w0 = self._w_limbs[0]
        c = (int(a.limbs[0]) - d * w0 - int(rem_int.limbs[0]))
        assert c % (1 << lb) == 0
        c >>= lb
        c_bits = self._round_chunk(lb + a.overflow + 2)
        assert c_bits + lb + 1 < 253, "reduce carry width unsound"
        offset = 1 << (c_bits - 1)
        c_cell = self.rgate.assign_ranged(ctx, c + offset, c_bits)
        # a0 - d*w0 - rem0 - (c_cell - offset)*2^limb = 0
        self.gate.one_line(
            ctx,
            [pair(a.limbs[0], 1), pair(d_cell, (-w0) % R),
             pair(rem_int.limbs[0], R - 1),
             pair(c_cell, (-(1 << lb)) % R)],
            constant=(offset << lb) % R,
        )
        return rem_int

    # -- multiplication ----------------------------------------------------
    def _fused_slices(self, ctx, a: AssignedInteger, b: AssignedInteger,
                      d_cells, d_limbs_v, sub_cells, pad_limbs, c_bits):
        """The two 2^(2*lb)-slice checks of a*b (+pad) - d*W - sub = 0, with
        the limb products folded INTO the chained slice rows (no separate
        conv cells — the density trick the reference gets from
        mul_add_with_next_line chains, five/integer_chip.rs:104-252).

        For slice s in {0,1}:
          L_s = sum_{k in {2s,2s+1}} (conv_k + pad_k - sum_i d_i*W_{k-i}
                                      - sub_k) * 2^(lb*(k-2s)) + carry_{s-1}
          L_s = carry_s * 2^(2lb), carries signed (offset-encoded)."""
        f = self.f
        lb = f.limb_bits
        assert c_bits + 2 * lb + 2 < R.bit_length(), "carry width unsound"
        offset = 1 << (c_bits - 1)
        carry_val = 0
        carry_cell = None
        for s in range(2):
            products = []
            d_coeffs = [0] * NLIMBS
            linears = []
            const = 0
            int_val = carry_val
            for t_i, k in enumerate((2 * s, 2 * s + 1)):
                shift = pow(2, lb * t_i, R)
                shift_int = 1 << (lb * t_i)
                for i in range(NLIMBS):
                    j = k - i
                    if 0 <= j < NLIMBS:
                        products.append((a.limbs[i], b.limbs[j], shift))
                        int_val += int(a.limbs[i]) * int(b.limbs[j]) * shift_int
                        d_coeffs[i] = (d_coeffs[i] - self._w_limbs[j] * shift) % R
                        int_val -= d_limbs_v[i] * self._w_limbs[j] * shift_int
                if pad_limbs is not None:
                    const = (const + pad_limbs[k] * shift) % R
                    int_val += pad_limbs[k] * shift_int
                linears.append((sub_cells[k], (-shift) % R))
                int_val -= int(sub_cells[k]) * shift_int
            for i in range(NLIMBS):
                if d_coeffs[i]:
                    linears.append((d_cells[i], d_coeffs[i]))
            if carry_cell is not None:
                linears.append((carry_cell, 1))
                const = (const - offset) % R  # remove previous offset
            assert int_val % (1 << (2 * lb)) == 0, "slice not divisible"
            c_new = int_val >> (2 * lb)
            c_cell = self.rgate.assign_ranged(ctx, c_new + offset, c_bits)
            linears.append((c_cell, (-(1 << (2 * lb))) % R))
            total_const = (const + (offset << (2 * lb))) % R
            self.gate.assert_products_sum_zero(ctx, products, linears, total_const)
            carry_val = c_new
            carry_cell = c_cell

    def mul(self, ctx, a: AssignedInteger, b: AssignedInteger) -> AssignedInteger:
        """a*b = d*W + rem, enforced mod r (native row) and mod 2^(4*limb)
        via limb-pair slices with signed range-checked carries
        (five/integer_chip.rs:104-287)."""
        f = self.f
        lb = f.limb_bits
        a, b = self._crt_budget_reduce(ctx, a, b)
        prod = a.value * b.value
        d = prod // f.modulus
        rem = prod % f.modulus

        # witnesses; static d bound: d < a.value*b.value/W
        d_bits = self._value_bits(a) + self._value_bits(b) - f.w_ceil_bits + 1
        a_nat, b_nat = self.nat(ctx, a), self.nat(ctx, b)
        rem_int = self.assign_w(ctx, rem)
        d_cells, d_native, d_limbs_v, _ = self._assign_d(ctx, d, d_bits)

        # native row: a.native * b.native - d.native*W - rem.native = 0 (mod r)
        self.gate.one_line(
            ctx,
            [pair(a_nat, 0), pair(b_nat, 0),
             pair(d_native, (-self._w_native) % R),
             pair(rem_int.native, R - 1)],
            mul_next=(1, 0, 0),
        )

        c_bits = self._round_chunk(lb + a.overflow + b.overflow + 8)
        self._fused_slices(ctx, a, b, d_cells, d_limbs_v, rem_int.limbs,
                           None, c_bits)
        return rem_int

    def _conv_int(self, a, b, k) -> int:
        lb = self.f.limb_bits
        total = 0
        for i in range(NLIMBS):
            j = k - i
            if 0 <= j < NLIMBS:
                total += int(a.limbs[i]) * int(b.limbs[j])
        return total

    def mul_match(self, ctx, a: AssignedInteger, b: AssignedInteger,
                  c: AssignedInteger) -> None:
        """Enforce a*b ≡ c (mod W) WITHOUT materializing the product:
        a*b + pad - c = d*W over the integers (pad a multiple of W whose limb
        split dominates c's limbs, so d >= 0), checked mod r (native row) and
        mod 2^(4*limb_bits) via the same limb-pair slice scheme as `mul`.

        This is the row-count backbone of in-circuit division and equality
        (the reference reaches its ~66-rows-per-point-op density with
        equivalent fused checks, five/integer_chip.rs:745-782)."""
        f = self.f
        lb = f.limb_bits
        a, b = self._crt_budget_reduce(ctx, a, b)
        pad_val, pad_limbs = self._padding_multiple(c)
        total = a.value * b.value + pad_val - c.value
        assert total >= 0 and total % f.modulus == 0, "mul_match witness mismatch"
        d = total // f.modulus

        d_bits = max(
            self._value_bits(a) + self._value_bits(b), pad_val.bit_length()
        ) - f.w_ceil_bits + 2
        a_nat, b_nat = self.nat(ctx, a), self.nat(ctx, b)
        c_nat = self.nat(ctx, c)
        d_cells, d_native, d_limbs_v, d_top_bits = self._assign_d(ctx, d, d_bits)

        # native row: a.native*b.native + pad - c.native - d.native*W = 0 (mod r)
        self.gate.one_line(
            ctx,
            [pair(a_nat, 0), pair(b_nat, 0),
             pair(d_native, (-self._w_native) % R),
             pair(c_nat, R - 1)],
            constant=pad_val % R,
            mul_next=(1, 0, 0),
        )

        c_bits = self._round_chunk(
            lb + a.overflow + b.overflow + max(c.overflow, d_top_bits - lb, 0) + 8)
        self._fused_slices(ctx, a, b, d_cells, d_limbs_v, c.limbs,
                           pad_limbs, c_bits)

    def square(self, ctx, a):
        return self.mul(ctx, a, a)

    # -- comparisons / conversions -----------------------------------------
    def is_zero(self, ctx, a: AssignedInteger) -> AssignedCell:
        """a == 0 (mod W): reduce, then value in {0, W} — checked on two
        packed limb halves lo = l0 + l1*2^lb, hi = l2 + l3*2^lb (exact over
        the integers since reduced limbs < 2^lb and 2*lb << |r|), the dense
        form of the reference's per-limb disjunction
        (five/integer_chip.rs:796-806)."""
        red = self.reduce(ctx, a) if a.overflow else a
        gate = self.gate
        f = self.f
        lb = f.limb_bits
        h = NLIMBS // 2
        # lo/hi each pack two limbs: < 2^(2*lb), exact iff 2*lb + 2 < |r|
        assert NLIMBS == 4 and 2 * lb + 2 < R.bit_length()
        shift = pow(2, lb, R)
        lo = gate.sum_with_coeff_and_constant(
            ctx, [(red.limbs[0], 1), (red.limbs[1], shift)], 0)
        hi = gate.sum_with_coeff_and_constant(
            ctx, [(red.limbs[2], 1), (red.limbs[3], shift)], 0)
        w_lo = (self._w_limbs[0] + (self._w_limbs[1] << lb)) % R
        w_hi = (self._w_limbs[2] + (self._w_limbs[3] << lb)) % R
        lo_w = gate.sum_with_coeff_and_constant(ctx, [(lo, 1)], (-w_lo) % R)
        hi_w = gate.sum_with_coeff_and_constant(ctx, [(hi, 1)], (-w_hi) % R)
        all_zero = gate.mul(ctx, gate.is_zero(ctx, lo), gate.is_zero(ctx, hi))
        all_w = gate.mul(ctx, gate.is_zero(ctx, lo_w), gate.is_zero(ctx, hi_w))
        # or: z = all_zero + all_w - all_zero*all_w (the cases are exclusive
        # for W > 0 but the complete form costs the same row)
        prod = gate.mul(ctx, all_zero, all_w)
        z = gate.sum_with_coeff_and_constant(
            ctx, [(all_zero, 1), (all_w, 1), (prod, R - 1)], 0
        )
        return z

    def get_last_bit(self, ctx, a: AssignedInteger) -> AssignedCell:
        """Parity bit of a reduced integer (five/integer_chip.rs:874-901):
        witness limb0 = 2*half + bit with half range-checked to limb_bits-1
        and bit boolean. Used for y-coordinate parity in the final-pair
        instance packing (verify_circuit.rs:281-284)."""
        assert a.overflow == 0, "get_last_bit requires a reduced integer"
        v = int(a.limbs[0])
        bit = v & 1
        half = v >> 1
        h_cell = self.rgate.assign_ranged(ctx, half, self.f.limb_bits - 1)
        b_cell = self.gate.assign(ctx, bit)
        self.gate.assert_bit(ctx, b_cell)
        # limb0 - 2*half - bit = 0
        self.gate.one_line(
            ctx, [pair(a.limbs[0], R - 1), pair(h_cell, 2), pair(b_cell, 1)]
        )
        return b_cell

    def assert_equal(self, ctx, a: AssignedInteger, b: AssignedInteger):
        """Enforce a ≡ b (mod W) directly: a + pad - b = d*W over the
        integers, checked exactly per limb with chained signed carries and a
        zero final carry (no CRT needed — the limb chain covers the full
        value). ~20 rows vs the old sub+is_zero path's ~120."""
        f = self.f
        lb = f.limb_bits
        pad_val, pad_limbs = self._padding_multiple(b)
        total = a.value + pad_val - b.value
        assert total >= 0 and total % f.modulus == 0, "assert_equal witness mismatch"
        d = total // f.modulus
        d_bits = max(self._value_bits(a), pad_val.bit_length()) - f.w_ceil_bits + 2
        assert 0 <= d < (1 << d_bits)
        d_cell = self.rgate.assign_ranged(ctx, d, d_bits)

        # native row: a.native + pad - b.native - d*W = 0 (mod r)
        a_nat, b_nat = self.nat(ctx, a), self.nat(ctx, b)
        self.gate.one_line(
            ctx,
            [pair(a_nat, 1), pair(b_nat, R - 1),
             pair(d_cell, (-self._w_native) % R)],
            constant=pad_val % R,
        )

        # per-limb: a_k + pad_k - b_k - d*W_k + carry_{k-1} = carry_k * 2^lb,
        # carries signed (offset-encoded, range-checked); final carry = 0
        c_bits = max(a.overflow, b.overflow + 3, d_bits) + 3
        offset = 1 << (c_bits - 1)
        carry_cell = None
        carry_val = 0
        for k in range(NLIMBS):
            v = (int(a.limbs[k]) + pad_limbs[k] - int(b.limbs[k])
                 - d * self._w_limbs[k] + carry_val)
            terms = [
                (a.limbs[k], 1),
                (b.limbs[k], R - 1),
                (d_cell, (-self._w_limbs[k]) % R),
            ]
            const = pad_limbs[k] % R
            if carry_cell is not None:
                terms.append((carry_cell, 1))
                const = (const - offset) % R
            if k < NLIMBS - 1:
                assert v % (1 << lb) == 0, "limb chain not divisible"
                carry_val = v >> lb
                assert -offset <= carry_val < offset, "carry exceeds bound"
                carry_cell = self.rgate.assign_ranged(ctx, carry_val + offset, c_bits)
                terms.append((carry_cell, (-(1 << lb)) % R))
                const = (const + ((offset << lb) % R)) % R
            else:
                assert v == 0, "final carry nonzero"
            self.gate.one_line(ctx, [pair(t, c) for t, c in terms], constant=const)

    def div_unsafe(self, ctx, a: AssignedInteger, b: AssignedInteger) -> AssignedInteger:
        """c = a/b via the fused constraint c*b ≡ a (mod W) (b must be
        invertible mod W; the reference ScalarChip div -> div_unsafe parity,
        five/integer_chip.rs:745-782 without the b=0 completeness branch)."""
        f = self.f
        c_val = a.value % f.modulus * pow(b.value % f.modulus, -1, f.modulus) % f.modulus
        c = self.assign_w(ctx, c_val)
        self.mul_match(ctx, c, b, a)
        return c

    def bisec(self, ctx, cond, a: AssignedInteger, b: AssignedInteger) -> AssignedInteger:
        gate = self.gate
        limbs = [gate.bisec(ctx, cond, x, y) for x, y in zip(a.limbs, b.limbs)]
        value = a.value if int(cond) else b.value
        return AssignedInteger(limbs, None, value, max(a.overflow, b.overflow),
                               max(self._value_bits(a), self._value_bits(b)))
