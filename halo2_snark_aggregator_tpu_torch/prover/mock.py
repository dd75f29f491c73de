# Copy of halo2_snark_aggregator_tpu/prover/mock.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""MockProver: direct constraint checking without proving.

The halo2 `MockProver` equivalent (the reference's gadget and integration
tests all assert `MockProver::verify()` — SURVEY §4). Evaluates every gate
polynomial on every row, checks copy (equality) constraints cell-by-cell, and
checks each lookup argument by multiset inclusion over the usable rows.

Row evaluation is vectorized over numpy object arrays (python-int elements):
the aggregation circuit (circuits/aggregator.py) assigns millions of rows, so
per-row Python loops are replaced by elementwise array arithmetic. Circuits
may set `assigner.used_rows_hint` after synthesis to bound the scan; the
hint is made SOUND rather than trusted: the scan always extends to the
highest row any assignment actually touched (plus the widest query rotation,
so rotated gates straddling the boundary are evaluated), and the all-zero
tail beyond the scan is checked symbolically — every gate must vanish and
every lookup's zero-row input tuple must hit the table on a zero row, which
is exactly the state of every unassigned row.

Unlike round 1 this also validates equality enablement: a `copy()` on a
column never passed to `cs.enable_equality` is reported as a failure (halo2
panics at keygen; a mock that silently value-checks such copies would bless
layouts the real prover cannot constrain).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ff.bn254 import R
from ..protocol.plonk import Circuit, ConstraintSystem, Expression
from .keygen import Assignment


@dataclasses.dataclass
class Failure:
    kind: str  # "gate" | "copy" | "lookup"
    detail: str


class MockProver:
    def __init__(self, circuit: Circuit, k: int, instances: list[list[int]]):
        cs = ConstraintSystem()
        config = circuit.configure(cs)
        n = 1 << k
        usable = n - (cs.blinding_factors() + 1)
        assignment = Assignment(cs, n, usable, instances)
        circuit.synthesize(config, assignment)
        self.cs = cs
        self.n = n
        self.usable = usable
        hint = getattr(assignment, "used_rows_hint", None)
        if hint:
            # a hint may only *extend* past the last touched row, never hide
            # it; widen by the largest |rotation| so gates that reference
            # row±rot across the boundary are still evaluated
            max_rot = max(
                (abs(r) for _, r in (cs.fixed_queries + cs.advice_queries
                                     + cs.instance_queries)), default=0)
            floor = assignment.max_row_touched + 1 + max_rot
            self.check_rows = min(usable, max(hint, floor))
        else:
            self.check_rows = usable
        self.assignment = assignment
        self._col_cache: dict = {}

    def _rows(self, kind: str, col: int, rot: int) -> np.ndarray:
        """Column values rotated by `rot`, as an object ndarray of length
        check_rows (wraparound over the full domain, matching halo2)."""
        key = (kind, col)
        base = self._col_cache.get(key)
        if base is None:
            n = self.n
            if kind == "fixed":
                vals = self.assignment.fixed[col]
            elif kind == "advice":
                vals = self.assignment.advice[col]
            else:
                v = self.assignment.instances[col]
                vals = v + [0] * (n - len(v))
            base = np.empty(n, dtype=object)
            base[:] = vals
            self._col_cache[key] = base
        if rot:
            base = np.roll(base, -rot)
        return base[: self.check_rows]

    def _expr_rows(self, e: Expression) -> np.ndarray:
        cs = self.cs
        m = self.check_rows

        def const(v):
            a = np.empty(m, dtype=object)
            a[:] = v
            return a

        return e.evaluate(
            constant=const,
            fixed=lambda q: self._rows("fixed", *cs.fixed_queries[q]),
            advice=lambda q: self._rows("advice", *cs.advice_queries[q]),
            instance=lambda q: self._rows("instance", *cs.instance_queries[q]),
            challenge=lambda i: const(1),  # challenges unsupported in mock runs
            neg=lambda a: (-a) % R,
            add=lambda a, b: (a + b) % R,
            mul=lambda a, b: a * b % R,
            scale=lambda a, s: a * s % R,
        )

    def _expr_zero(self, e: Expression) -> int:
        """Expression value on an unassigned (all-default) row: every queried
        cell is 0, challenges evaluate as in the row scan."""
        return e.evaluate(
            constant=lambda v: v % R,
            fixed=lambda q: 0,
            advice=lambda q: 0,
            instance=lambda q: 0,
            challenge=lambda i: 1,
            neg=lambda a: (-a) % R,
            add=lambda a, b: (a + b) % R,
            mul=lambda a, b: a * b % R,
            scale=lambda a, s: a * s % R,
        )

    def verify(self) -> list[Failure]:
        failures: list[Failure] = []
        tail_unscanned = self.check_rows < self.usable
        # gates over the scanned rows
        for name, polys in self.cs.gates:
            for gi, poly in enumerate(polys):
                rows = self._expr_rows(poly)
                bad = np.nonzero(rows)[0]
                if bad.size:
                    failures.append(Failure(
                        "gate", f"gate '{name}'[{gi}] != 0 at row {bad[0]}"))
                elif tail_unscanned and self._expr_zero(poly) != 0:
                    failures.append(Failure(
                        "gate",
                        f"gate '{name}'[{gi}] != 0 on unassigned all-zero "
                        f"tail rows {self.check_rows}..{self.usable - 1}"))
        # copy constraints: value equality AND equality enablement (halo2
        # keygen panics on a copy over a non-enabled column; value-checking
        # such a copy would bless a layout the permutation cannot constrain)
        cell_value = self.assignment.cell_value
        enabled = set(self.cs.permutation_columns)
        unenabled_reported = set()
        for (ca, ra, cb, rb) in self.assignment.copies:
            for c in (ca, cb):
                if c not in enabled and c not in unenabled_reported:
                    unenabled_reported.add(c)
                    failures.append(Failure(
                        "copy",
                        f"{c} used in copy constraints but never passed to "
                        f"cs.enable_equality"))
            va = cell_value(ca, ra)
            vb = cell_value(cb, rb)
            if va % R != vb % R:
                failures.append(Failure(
                    "copy", f"{ca}@{ra} = {va} != {cb}@{rb} = {vb}"))
        # lookups (multiset inclusion over the scanned rows)
        for lk in self.cs.lookups:
            in_cols = [self._expr_rows(e) for e in lk.input_expressions]
            tab_cols = [self._expr_rows(e) for e in lk.table_expressions]
            if len(in_cols) == 1:
                table = set(tab_cols[0].tolist())
                if tail_unscanned:
                    table.add(self._expr_zero(lk.table_expressions[0]))
                    if self._expr_zero(lk.input_expressions[0]) not in table:
                        failures.append(Failure(
                            "lookup",
                            f"lookup '{lk.name}' misses on unassigned tail rows"))
                miss = [i for i, v in enumerate(in_cols[0].tolist())
                        if v not in table]
            else:
                table = set(zip(*[c.tolist() for c in tab_cols]))
                if tail_unscanned:
                    table.add(tuple(self._expr_zero(e)
                                    for e in lk.table_expressions))
                    zin = tuple(self._expr_zero(e)
                                for e in lk.input_expressions)
                    if zin not in table:
                        failures.append(Failure(
                            "lookup",
                            f"lookup '{lk.name}' misses on unassigned tail rows"))
                miss = [i for i, v in enumerate(zip(*[c.tolist() for c in in_cols]))
                        if v not in table]
            if miss:
                failures.append(Failure(
                    "lookup", f"lookup '{lk.name}' miss at row {miss[0]}"))
        return failures

    def assert_satisfied(self):
        failures = self.verify()
        if failures:
            raise AssertionError(
                "MockProver failures:\n" + "\n".join(f"  {f.kind}: {f.detail}" for f in failures)
            )
