# Frozen copy of halo2_snark_aggregator_tpu_torch/protocol/plonk.py for the benchmark's
# plain reference: imports rewritten to this folder, the native (C++)
# fast paths removed. It imports nothing of the program under test.
"""PLONKish constraint-system model (halo2-compatible).

This is the framework's equivalent of `halo2_proofs::plonk::{Expression,
ConstraintSystem, VerifyingKey}` that the reference verifier walks
(halo2-snark-aggregator-api/src/systems/halo2/verify.rs:342-571 reads
`vk.cs()` metadata to drive transcript replay; expression.rs:5-114 interprets
`Expression` trees). We model the same metadata natively in Python so the
TPU-side protocol engine can statically stage all control flow from the vk
(shapes and schedules known at trace time — SURVEY.md §7 hard part 3/4).

Selector semantics: halo2 compresses "simple selectors" into fixed columns
before keygen (the reference panics on virtual selectors,
expression.rs:36-38); we use fixed columns for selectors from the start.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from .bn254 import R as FR

# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------


class Expression:
    """Polynomial expression over column queries.

    Node kinds mirror halo2's `Expression` (constant, fixed/advice/instance
    query by *query index*, challenge, negation, sum, product, scaled).
    """

    KIND_CONST = "const"
    KIND_FIXED = "fixed"
    KIND_ADVICE = "advice"
    KIND_INSTANCE = "instance"
    KIND_CHALLENGE = "challenge"
    KIND_NEG = "neg"
    KIND_SUM = "sum"
    KIND_PROD = "prod"
    KIND_SCALED = "scaled"

    __slots__ = ("kind", "value", "a", "b")

    def __init__(self, kind, value=None, a=None, b=None):
        self.kind = kind
        self.value = value
        self.a = a
        self.b = b

    # -- constructors ------------------------------------------------------
    @staticmethod
    def const(v: int) -> "Expression":
        return Expression(Expression.KIND_CONST, v % FR)

    @staticmethod
    def fixed(query_index: int) -> "Expression":
        return Expression(Expression.KIND_FIXED, query_index)

    @staticmethod
    def advice(query_index: int) -> "Expression":
        return Expression(Expression.KIND_ADVICE, query_index)

    @staticmethod
    def instance(query_index: int) -> "Expression":
        return Expression(Expression.KIND_INSTANCE, query_index)

    @staticmethod
    def challenge(index: int) -> "Expression":
        return Expression(Expression.KIND_CHALLENGE, index)

    # -- operators ---------------------------------------------------------
    def __add__(self, o):
        o = _coerce(o)
        return Expression(Expression.KIND_SUM, a=self, b=o)

    def __sub__(self, o):
        o = _coerce(o)
        return Expression(Expression.KIND_SUM, a=self, b=Expression(Expression.KIND_NEG, a=o))

    def __neg__(self):
        return Expression(Expression.KIND_NEG, a=self)

    def __mul__(self, o):
        if isinstance(o, int):
            return Expression(Expression.KIND_SCALED, value=o % FR, a=self)
        return Expression(Expression.KIND_PROD, a=self, b=o)

    __radd__ = __add__
    __rmul__ = __mul__

    def degree(self) -> int:
        k = self.kind
        if k == Expression.KIND_CONST or k == Expression.KIND_CHALLENGE:
            return 0
        if k in (Expression.KIND_FIXED, Expression.KIND_ADVICE, Expression.KIND_INSTANCE):
            return 1
        if k == Expression.KIND_NEG or k == Expression.KIND_SCALED:
            return self.a.degree()
        if k == Expression.KIND_SUM:
            return max(self.a.degree(), self.b.degree())
        if k == Expression.KIND_PROD:
            return self.a.degree() + self.b.degree()
        raise ValueError(k)

    def evaluate(
        self,
        constant: Callable,
        fixed: Callable,
        advice: Callable,
        instance: Callable,
        challenge: Callable,
        neg: Callable,
        add: Callable,
        mul: Callable,
        scale: Callable,
    ):
        """Fold the tree with the given handlers (mirrors halo2 Expression::evaluate
        / reference expression.rs chip_evaluate)."""
        k = self.kind
        if k == Expression.KIND_CONST:
            return constant(self.value)
        if k == Expression.KIND_FIXED:
            return fixed(self.value)
        if k == Expression.KIND_ADVICE:
            return advice(self.value)
        if k == Expression.KIND_INSTANCE:
            return instance(self.value)
        if k == Expression.KIND_CHALLENGE:
            return challenge(self.value)
        if k == Expression.KIND_NEG:
            return neg(self.a.evaluate(constant, fixed, advice, instance, challenge, neg, add, mul, scale))
        if k == Expression.KIND_SUM:
            return add(
                self.a.evaluate(constant, fixed, advice, instance, challenge, neg, add, mul, scale),
                self.b.evaluate(constant, fixed, advice, instance, challenge, neg, add, mul, scale),
            )
        if k == Expression.KIND_PROD:
            return mul(
                self.a.evaluate(constant, fixed, advice, instance, challenge, neg, add, mul, scale),
                self.b.evaluate(constant, fixed, advice, instance, challenge, neg, add, mul, scale),
            )
        if k == Expression.KIND_SCALED:
            return scale(
                self.a.evaluate(constant, fixed, advice, instance, challenge, neg, add, mul, scale),
                self.value,
            )
        raise ValueError(k)


def _coerce(o):
    if isinstance(o, int):
        return Expression.const(o)
    return o


# ---------------------------------------------------------------------------
# Columns
# ---------------------------------------------------------------------------

FIXED = "fixed"
ADVICE = "advice"
INSTANCE = "instance"


@dataclasses.dataclass(frozen=True, order=True)
class Column:
    kind: str
    index: int


@dataclasses.dataclass
class LookupArgument:
    name: str
    input_expressions: list
    table_expressions: list

    def required_degree(self) -> int:
        """halo2 lookup::Argument::required_degree: max(4, 2 + in_deg + tab_deg)."""
        in_deg = max([1] + [e.degree() for e in self.input_expressions])
        tab_deg = max([1] + [e.degree() for e in self.table_expressions])
        return max(4, 2 + in_deg + tab_deg)


# ---------------------------------------------------------------------------
# Constraint system
# ---------------------------------------------------------------------------


class ConstraintSystem:
    def __init__(self):
        self.num_fixed_columns = 0
        self.num_advice_columns = 0
        self.num_instance_columns = 0
        self.num_challenges = 0
        self.advice_column_phase: list[int] = []
        self.challenge_phase: list[int] = []
        self.gates: list[tuple[str, list[Expression]]] = []
        self.lookups: list[LookupArgument] = []
        self.permutation_columns: list[Column] = []
        # query lists: (column_index, rotation)
        self.fixed_queries: list[tuple[int, int]] = []
        self.advice_queries: list[tuple[int, int]] = []
        self.instance_queries: list[tuple[int, int]] = []
        self.minimum_degree: int | None = None

    # -- column allocation -------------------------------------------------
    def fixed_column(self) -> Column:
        c = Column(FIXED, self.num_fixed_columns)
        self.num_fixed_columns += 1
        return c

    def advice_column(self, phase: int = 0) -> Column:
        c = Column(ADVICE, self.num_advice_columns)
        self.num_advice_columns += 1
        self.advice_column_phase.append(phase)
        return c

    def instance_column(self) -> Column:
        c = Column(INSTANCE, self.num_instance_columns)
        self.num_instance_columns += 1
        return c

    def challenge_usable_after(self, phase: int) -> int:
        """halo2 semantics: the challenge is squeezed at the END of `phase`
        (right after that phase's advice commitments), so it is usable by
        advice columns of phase+1 during witness synthesis."""
        idx = self.num_challenges
        self.num_challenges += 1
        self.challenge_phase.append(phase)
        return idx

    def phases(self) -> list[int]:
        max_phase = max([0] + self.advice_column_phase + self.challenge_phase)
        return list(range(max_phase + 1))

    # -- queries -----------------------------------------------------------
    def _query(self, queries: list, column_index: int, rotation: int) -> int:
        for i, (c, r) in enumerate(queries):
            if c == column_index and r == rotation:
                return i
        queries.append((column_index, rotation))
        return len(queries) - 1

    def query_fixed(self, column: Column, rotation: int = 0) -> Expression:
        assert column.kind == FIXED
        return Expression.fixed(self._query(self.fixed_queries, column.index, rotation))

    def query_advice(self, column: Column, rotation: int = 0) -> Expression:
        assert column.kind == ADVICE
        return Expression.advice(self._query(self.advice_queries, column.index, rotation))

    def query_instance(self, column: Column, rotation: int = 0) -> Expression:
        assert column.kind == INSTANCE
        return Expression.instance(self._query(self.instance_queries, column.index, rotation))

    def query_any(self, column: Column, rotation: int = 0) -> Expression:
        return {
            FIXED: self.query_fixed,
            ADVICE: self.query_advice,
            INSTANCE: self.query_instance,
        }[column.kind](column, rotation)

    def get_any_query_index(self, column: Column, rotation: int = 0) -> int:
        """Index of an existing query (reference verify.rs:247-261 uses
        vk.cs().get_any_query_index for permutation column evals)."""
        queries = {
            FIXED: self.fixed_queries,
            ADVICE: self.advice_queries,
            INSTANCE: self.instance_queries,
        }[column.kind]
        for i, (c, r) in enumerate(queries):
            if c == column.index and r == rotation:
                return i
        raise KeyError((column, rotation))

    # -- gates / lookups / permutation --------------------------------------
    def create_gate(self, name: str, polys: list[Expression]):
        assert polys, "gate must have at least one constraint"
        self.gates.append((name, polys))

    def lookup(self, name: str, table_map: list[tuple[Expression, Expression]]):
        self.lookups.append(
            LookupArgument(
                name,
                [i for i, _ in table_map],
                [t for _, t in table_map],
            )
        )

    def enable_equality(self, column: Column):
        if column not in self.permutation_columns:
            self.permutation_columns.append(column)
            # halo2 registers a cur-rotation query for every equality column
            self.query_any(column, 0)

    # -- derived quantities (must match the reference's reads of vk.cs()) ---
    def degree(self) -> int:
        d = 3  # permutation::Argument::required_degree
        for lk in self.lookups:
            d = max(d, lk.required_degree())
        for _, polys in self.gates:
            for p in polys:
                d = max(d, p.degree())
        if self.minimum_degree is not None:
            d = max(d, self.minimum_degree)
        return d

    def blinding_factors(self) -> int:
        """halo2 ConstraintSystem::blinding_factors."""
        counts: dict[int, int] = {}
        for c, _ in self.advice_queries:
            counts[c] = counts.get(c, 0) + 1
        factors = max(counts.values()) if counts else 1
        factors = max(3, factors)
        factors += 1  # multiopen at x
        return factors + 1  # defense against small-domain attacks

    def permutation_chunk_len(self) -> int:
        return self.degree() - 2

    def permutation_num_chunks(self) -> int:
        cl = self.permutation_chunk_len()
        ncols = len(self.permutation_columns)
        return (ncols + cl - 1) // cl if ncols else 0


# ---------------------------------------------------------------------------
# Circuit interface ("TargetCircuit" analog, cf. circuit/src/sample_circuit.rs:20-40)
# ---------------------------------------------------------------------------


class Circuit:
    """A circuit configures a ConstraintSystem and assigns witness values.

    synthesize() receives an Assignment-like object with:
      assign_advice(col, row, value), assign_fixed(col, row, value),
      copy(col_a, row_a, col_b, row_b)
    Instance values are provided externally per instance column.
    """

    def configure(self, cs: ConstraintSystem):
        raise NotImplementedError

    def synthesize(self, config, assigner):
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Verifying key
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class VerifyingKey:
    k: int
    cs: ConstraintSystem
    fixed_commitments: list  # G1 points
    permutation_commitments: list  # G1 points (sigma commitments)

    @property
    def n(self) -> int:
        return 1 << self.k

    def quotient_poly_degree(self) -> int:
        return self.cs.degree() - 1

    def transcript_repr(self) -> int:
        """blake2b-512 digest of a canonical vk serialization, reduced into Fr.

        Mirrors the reference's init_transcript (verify.rs:56-72): blake2b with
        personal "Halo2-Verify-Key", absorbing u64-LE length then the pinned-vk
        string.

        The "native" pinned-string style only (the program's default).
        """
        import hashlib

        from .bn254 import fe_from_bytes_wide

        s = self._pinned_str().encode()
        h = hashlib.blake2b(digest_size=64, person=b"Halo2-Verify-Key")
        h.update(len(s).to_bytes(8, "little"))
        h.update(s)
        return fe_from_bytes_wide(h.digest(), FR)

    def _pinned_str(self) -> str:
        cs = self.cs
        parts = [
            f"k={self.k}",
            f"nf={cs.num_fixed_columns}",
            f"na={cs.num_advice_columns}",
            f"ni={cs.num_instance_columns}",
            f"nc={cs.num_challenges}",
            f"aph={cs.advice_column_phase}",
            f"cph={cs.challenge_phase}",
            f"mind={cs.minimum_degree}",
            f"fq={cs.fixed_queries}",
            f"aq={cs.advice_queries}",
            f"iq={cs.instance_queries}",
            f"perm={[(c.kind, c.index) for c in cs.permutation_columns]}",
            f"gates={[_expr_str(p) for _, ps in cs.gates for p in ps]}",
            f"lookups={[( [_expr_str(e) for e in lk.input_expressions], [_expr_str(e) for e in lk.table_expressions]) for lk in cs.lookups]}",
            f"fixedc={self.fixed_commitments}",
            f"permc={self.permutation_commitments}",
        ]
        return ";".join(parts)


def _expr_str(e: Expression) -> str:
    k = e.kind
    if k in (Expression.KIND_CONST, Expression.KIND_FIXED, Expression.KIND_ADVICE,
             Expression.KIND_INSTANCE, Expression.KIND_CHALLENGE):
        return f"{k}({e.value})"
    if k == Expression.KIND_NEG:
        return f"-({_expr_str(e.a)})"
    if k == Expression.KIND_SUM:
        return f"({_expr_str(e.a)}+{_expr_str(e.b)})"
    if k == Expression.KIND_PROD:
        return f"({_expr_str(e.a)}*{_expr_str(e.b)})"
    if k == Expression.KIND_SCALED:
        return f"({e.value}*{_expr_str(e.a)})"
    raise ValueError(k)
