# Copy of halo2_snark_aggregator_tpu/gadgets/base_gate.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""Universal PLONK base gate (reference halo2-ecc-circuit-lib B1/B2).

One gate row enforces
    constant + sum_i advice_i * coeff_i
             + mul0 * advice_0 * advice_1 + mul1 * advice_2 * advice_3
             + next_coeff * advice_0(next row)            = 0
over VAR_COLUMNS=5 advice columns with per-row fixed coefficient columns —
the same row shape as the reference's FiveColumnBaseGate
(gates/base_gate.rs:148-155, 701-720; five/config.rs VAR_COLUMNS=5
MUL_COLUMNS=2). Higher gadgets (range gate, non-native integer chip, ECC
chip) compose rows through `one_line`.

Witness values here are plain ints; constraint layout is identical between
keygen (structure) and proving (values), driven by the same synthesize run —
the in-circuit counterpart of the value context, generated by replaying the
same verifier algorithm (SURVEY §7 "one algorithm, three contexts").
"""

from __future__ import annotations

import dataclasses

from ..ff.bn254 import R
from ..protocol.plonk import Column, ConstraintSystem

VAR_COLUMNS = 5
MUL_COLUMNS = 2


class AssignedCell:
    """A witnessed base-gate cell (col = index into the base-gate advice
    columns). Plain __slots__ class — this is the single hottest allocation
    in circuit synthesis; treat instances as immutable."""

    __slots__ = ("col", "row", "value")

    def __init__(self, col: int, row: int, value: int):
        self.col = col
        self.row = row
        self.value = value

    def __int__(self):
        return self.value

    def __repr__(self):
        return f"AssignedCell(col={self.col}, row={self.row}, value={self.value})"


def pair(value, coeff: int):
    """Schema pair: (AssignedCell | int witness, coefficient)."""
    return (value, coeff % R)


@dataclasses.dataclass
class BaseGateConfig:
    advice: list[Column]
    coeff: list[Column]       # VAR_COLUMNS fixed coefficient columns
    mul_coeff: list[Column]   # MUL_COLUMNS fixed columns
    next_coeff: Column
    constant: Column


class Context:
    """Row cursor over an Assignment (reference Context{region, offset},
    base_gate.rs:113-146)."""

    def __init__(self, assignment):
        self.assignment = assignment
        self.offset = 0

    def __repr__(self):
        return f"Context(offset={self.offset})"


class BaseGate:
    def __init__(self, config: BaseGateConfig):
        self.config = config
        # hot-path caches: raw column indices for direct list access
        self._adv_cols = list(config.advice)
        self._adv_idx = [c.index for c in config.advice]
        self._coeff_idx = [c.index for c in config.coeff]
        self._mul_idx = [c.index for c in config.mul_coeff]
        self._next_idx = config.next_coeff.index
        self._const_idx = config.constant.index

    # -- configuration ------------------------------------------------------
    @staticmethod
    def configure(cs: ConstraintSystem) -> BaseGateConfig:
        advice = [cs.advice_column() for _ in range(VAR_COLUMNS)]
        coeff = [cs.fixed_column() for _ in range(VAR_COLUMNS)]
        mul_coeff = [cs.fixed_column() for _ in range(MUL_COLUMNS)]
        next_coeff = cs.fixed_column()
        constant = cs.fixed_column()
        for a in advice:
            cs.enable_equality(a)

        expr = cs.query_fixed(constant, 0)
        for i in range(VAR_COLUMNS):
            expr = expr + cs.query_advice(advice[i], 0) * cs.query_fixed(coeff[i], 0)
        expr = expr + (
            cs.query_advice(advice[0], 0)
            * cs.query_advice(advice[1], 0)
            * cs.query_fixed(mul_coeff[0], 0)
        )
        expr = expr + (
            cs.query_advice(advice[2], 0)
            * cs.query_advice(advice[3], 0)
            * cs.query_fixed(mul_coeff[1], 0)
        )
        expr = expr + cs.query_advice(advice[0], 1) * cs.query_fixed(next_coeff, 0)
        cs.create_gate("base_gate", [expr])
        return BaseGateConfig(advice, coeff, mul_coeff, next_coeff, constant)

    # -- row assembly --------------------------------------------------------
    def one_line(self, ctx: Context, pairs, constant: int = 0,
                 mul_next=(0, 0, 0)) -> list[AssignedCell]:
        """Assign one gate row (base_gate.rs one_line).

        pairs: up to VAR_COLUMNS `(value, coeff)` entries; an AssignedCell
        value gets equality-copied, a plain int becomes a fresh witness.
        Coefficients must already be reduced mod R (`pair()` guarantees it).
        mul_next: (mul_coeff0, mul_coeff1, next_coeff).
        Returns the assigned cells for the provided pairs (column order);
        unprovided columns stay at their zero-initialized default.
        """
        assert len(pairs) <= VAR_COLUMNS
        asg = ctx.assignment
        row = ctx.offset
        if row >= asg.usable_rows:
            raise AssertionError(f"circuit overflow: row {row} >= usable {asg.usable_rows}")
        advice = asg.advice
        fixed = asg.fixed
        adv_cols = self._adv_cols
        adv_idx = self._adv_idx
        coeff_idx = self._coeff_idx
        copies = asg.copies
        cells = []
        for i, (value, coeff) in enumerate(pairs):
            if type(value) is AssignedCell:
                v = value.value
                copies.append((adv_cols[value.col], value.row, adv_cols[i], row))
            else:
                v = value % R
            if v:
                advice[adv_idx[i]][row] = v
            if coeff:
                fixed[coeff_idx[i]][row] = coeff
            cells.append(AssignedCell(i, row, v))
        if mul_next[0]:
            fixed[self._mul_idx[0]][row] = mul_next[0]
        if mul_next[1]:
            fixed[self._mul_idx[1]][row] = mul_next[1]
        if mul_next[2]:
            fixed[self._next_idx][row] = mul_next[2]
        if constant:
            fixed[self._const_idx][row] = constant % R
        ctx.offset += 1
        return cells

    def one_line_with_last(self, ctx, pairs, last_pair, constant=0, mul_next=(0, 0, 0)):
        """Row whose VAR_COLUMNS-1 slot holds `last_pair` (common layout)."""
        assert len(pairs) <= VAR_COLUMNS - 1
        padded = list(pairs) + [pair(0, 0)] * (VAR_COLUMNS - 1 - len(pairs)) + [last_pair]
        return self.one_line(ctx, padded, constant, mul_next)

    # -- arithmetic ops (base_gate.rs:157-673) -------------------------------
    def assign_constant(self, ctx, v: int) -> AssignedCell:
        cells = self.one_line(ctx, [pair(v, R - 1)], constant=v)
        return cells[0]

    def assign(self, ctx, v: int) -> AssignedCell:
        return self.one_line(ctx, [pair(v, 0)])[0]

    def assert_constant(self, ctx, cell: AssignedCell, v: int):
        self.one_line(ctx, [pair(cell, R - 1)], constant=v)

    def assert_equal(self, ctx, a: AssignedCell, b: AssignedCell):
        self.one_line(ctx, [pair(a, 1), pair(b, R - 1)])

    def add(self, ctx, a, b) -> AssignedCell:
        s = (int(a) + int(b)) % R
        cells = self.one_line(ctx, [pair(a, 1), pair(b, 1), pair(s, R - 1)])
        return cells[2]

    def sub(self, ctx, a, b) -> AssignedCell:
        d = (int(a) - int(b)) % R
        cells = self.one_line(ctx, [pair(a, 1), pair(b, R - 1), pair(d, R - 1)])
        return cells[2]

    def neg(self, ctx, a) -> AssignedCell:
        d = (-int(a)) % R
        cells = self.one_line(ctx, [pair(a, 1), pair(d, 1)])
        return cells[1]

    def mul(self, ctx, a, b) -> AssignedCell:
        p = int(a) * int(b) % R
        cells = self.one_line(
            ctx, [pair(a, 0), pair(b, 0), pair(p, R - 1)], mul_next=(1, 0, 0)
        )
        return cells[2]

    def mul_add(self, ctx, a, b, c) -> AssignedCell:
        """returns a*b + c."""
        out = (int(a) * int(b) + int(c)) % R
        cells = self.one_line(
            ctx,
            [pair(a, 0), pair(b, 0), pair(c, 1), pair(out, R - 1)],
            mul_next=(1, 0, 0),
        )
        return cells[3]

    def mul_add_constant(self, ctx, a, b, c: int) -> AssignedCell:
        out = (int(a) * int(b) + c) % R
        cells = self.one_line(
            ctx, [pair(a, 0), pair(b, 0), pair(out, R - 1)],
            constant=c, mul_next=(1, 0, 0),
        )
        return cells[2]

    def sum_with_coeff_and_constant(self, ctx, pairs_in, constant: int = 0) -> AssignedCell:
        """Multi-row accumulate of sum coeff_i * v_i + constant
        (base_gate.rs:193-262). Dense layout: the first row holds up to
        VAR_COLUMNS terms chained via next_coeff into the following row's
        first column, which carries the partial sum (coeff 1) alongside up to
        VAR_COLUMNS-1 further terms. When <= VAR_COLUMNS-1 terms remain the
        result cell itself takes the last slot (coeff -1) — no landing row.
        n terms cost ceil((n-4)/4)+1 rows (1 row for n<=4)."""
        constant %= R
        terms = [(v, c % R) for v, c in pairs_in]
        total = (constant + sum(
            (v.value if type(v) is AssignedCell else v % R) * c for v, c in terms)) % R
        if not terms:
            return self.assign_constant(ctx, constant)
        acc_cell: AssignedCell | None = None
        first = True
        while True:
            cap = VAR_COLUMNS if acc_cell is None else VAR_COLUMNS - 1
            row_pairs = [] if acc_cell is None else [(acc_cell, 1)]
            row_constant = constant if first else 0
            if len(terms) <= cap - 1:
                # final row: remaining terms + the result cell, closes to 0
                row_pairs += terms + [(total, R - 1)]
                cells = self.one_line(ctx, row_pairs, constant=row_constant)
                return cells[-1]
            chunk, terms = terms[:cap], terms[cap:]
            row_pairs += chunk
            carry_in = acc_cell.value if acc_cell is not None else 0
            new_acc = (row_constant + carry_in
                       + sum((v.value if type(v) is AssignedCell else v % R) * c
                             for v, c in chunk)) % R
            # row: const + sum(coeff*v) + carry_in - next.advice0 = 0
            self.one_line(ctx, row_pairs, constant=row_constant, mul_next=(0, 0, R - 1))
            # the chained partial lands in the NEXT row's col 0 (it becomes
            # that row's first pair); materialize it as a cell value now
            acc_cell = AssignedCell(0, ctx.offset, new_acc)
            # reserve col 0 of the upcoming row by pre-writing the advice; the
            # next loop iteration's one_line will place it as its first pair
            first = False

    def assert_sum_zero(self, ctx, pairs_in, constant: int = 0):
        """Enforce sum coeff_i * v_i + constant = 0 with the dense chained
        layout and no result cell (the last row closes the relation)."""
        constant %= R
        terms = [(v, c % R) for v, c in pairs_in]
        acc_cell: AssignedCell | None = None
        first = True
        while True:
            cap = VAR_COLUMNS if acc_cell is None else VAR_COLUMNS - 1
            row_pairs = [] if acc_cell is None else [(acc_cell, 1)]
            row_constant = constant if first else 0
            if len(terms) <= cap:
                self.one_line(ctx, row_pairs + terms, constant=row_constant)
                return
            chunk, terms = terms[:cap], terms[cap:]
            row_pairs += chunk
            carry_in = acc_cell.value if acc_cell is not None else 0
            new_acc = (row_constant + carry_in
                       + sum((v.value if type(v) is AssignedCell else v % R) * c
                             for v, c in chunk)) % R
            self.one_line(ctx, row_pairs, constant=row_constant, mul_next=(0, 0, R - 1))
            acc_cell = AssignedCell(0, ctx.offset, new_acc)
            first = False

    def sum_with_constant(self, ctx, values, constant: int = 0) -> AssignedCell:
        return self.sum_with_coeff_and_constant(ctx, [(v, 1) for v in values], constant)

    def assert_products_sum_zero(self, ctx, products, linears, constant: int = 0):
        """Enforce sum m_k * a_k * b_k + sum c_i * v_i + constant = 0.

        products: [(a, b, coeff)]; linears: [(v, coeff)]. Rows chain partial
        sums via next_coeff. The first row fits two products (both mul slots);
        carry rows fit one product (mul slot 1, advice 2*3) since the carry
        occupies advice 0. Free slots take linear terms. This is the dense
        layout behind the integer chip's fused d*W+rem slice checks (the
        reference reaches equivalent density with mul_add chains,
        five/base_gate.rs:112-129)."""
        constant %= R
        prods = [(a, b, c % R) for a, b, c in products]
        lins = [(v, c % R) for v, c in linears]
        acc_cell: AssignedCell | None = None
        first = True
        while True:
            row_constant = constant if first else 0
            pairs = []
            mul0 = mul1 = 0
            if acc_cell is None:
                # fresh row: both mul slots usable (advice 0*1 and 2*3)
                if prods:
                    a, b, c = prods.pop(0)
                    pairs += [(a, 0), (b, 0)]
                    mul0 = c
                    if prods:
                        a2, b2, c2 = prods.pop(0)
                        pairs += [(a2, 0), (b2, 0)]
                        mul1 = c2
            else:
                # carry occupies advice0 (coeff 1): only mul slot 1 usable
                pairs.append((acc_cell, 1))
                if prods:
                    if lins:
                        pairs.append(lins.pop(0))  # advice1
                    else:
                        pairs.append((0, 0))
                    a, b, c = prods.pop(0)
                    pairs += [(a, 0), (b, 0)]      # advice2, advice3
                    mul1 = c
            while lins and len(pairs) < VAR_COLUMNS:
                pairs.append(lins.pop(0))
            vals = [(v.value if type(v) is AssignedCell else v % R)
                    for v, _ in pairs] + [0] * (VAR_COLUMNS - len(pairs))
            lin_sum = sum(v * c for v, (_, c) in zip(vals, pairs))
            row_sum = (row_constant + lin_sum
                       + mul0 * vals[0] * vals[1] + mul1 * vals[2] * vals[3]) % R
            if not prods and not lins:
                assert row_sum == 0, "products sum does not close to zero"
                self.one_line(ctx, pairs, constant=row_constant,
                              mul_next=(mul0, mul1, 0))
                return
            self.one_line(ctx, pairs, constant=row_constant,
                          mul_next=(mul0, mul1, R - 1))
            acc_cell = AssignedCell(0, ctx.offset, row_sum)
            first = False

    def div_unsafe(self, ctx, a, b) -> AssignedCell:
        """c = a / b via the row b*c - a = 0 (b must be nonzero)."""
        c = int(a) * pow(int(b), -1, R) % R
        cells = self.one_line(
            ctx, [pair(b, 0), pair(c, 0), pair(a, R - 1)], mul_next=(1, 0, 0)
        )
        return cells[1]

    def is_zero(self, ctx, a) -> AssignedCell:
        """Returns bit z with z = 1 iff a == 0 (complete; base_gate.rs is_zero):
        witness inv = a^-1 (or 0); constraints z = 1 - a*inv and a*z = 0."""
        av = int(a) % R
        inv = pow(av, -1, R) if av else 0
        z = 1 if av == 0 else 0
        # row 1: a*inv + z - 1 = 0
        cells = self.one_line(
            ctx, [pair(a, 0), pair(inv, 0), pair(z, 1)],
            constant=R - 1, mul_next=(1, 0, 0),
        )
        z_cell = cells[2]
        # row 2: a*z = 0
        self.one_line(ctx, [pair(a, 0), pair(z_cell, 0)], mul_next=(1, 0, 0))
        return z_cell

    def invert(self, ctx, a) -> tuple[AssignedCell, AssignedCell]:
        """Complete inversion (base_gate.rs:439-467): returns (z, inv) where
        z = [a == 0] and a*inv = 1 - z (inv = 0 when a == 0)."""
        av = int(a) % R
        inv = pow(av, -1, R) if av else 0
        z_cell = self.is_zero(ctx, a)
        # a*inv + z - 1 = 0
        cells = self.one_line(
            ctx, [pair(a, 0), pair(inv, 0), pair(z_cell, 1)],
            constant=R - 1, mul_next=(1, 0, 0),
        )
        return z_cell, cells[1]

    def bisec(self, ctx, cond, a, b) -> AssignedCell:
        """cond ? a : b, cond a bit: cond*a - cond*b + b - out = 0
        (five/base_gate.rs:84-110 one-row form with two mul slots)."""
        cv = int(cond) % R
        out = (cv * int(a) + (1 - cv) * int(b)) % R
        # cond*a (mul0) - cond*b (mul1) + b - out = 0
        cells = self.one_line(
            ctx,
            [pair(cond, 0), pair(a, 0), pair(cond, 0), pair(b, 1), pair(out, R - 1)],
            mul_next=(1, R - 1, 0),
        )
        return cells[4]

    def assert_bit(self, ctx, a):
        """a * (a - 1) = 0."""
        self.one_line(
            ctx, [pair(a, 0), pair(a, R - 1)], mul_next=(1, 0, 0)
        )

    def assert_false(self, ctx, a):
        self.assert_constant(ctx, a, 0)

    def assert_true(self, ctx, a):
        self.assert_constant(ctx, a, 1)
