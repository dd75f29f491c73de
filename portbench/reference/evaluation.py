# Frozen copy of halo2_snark_aggregator_tpu_torch/protocol/evaluation.py for the benchmark's
# plain reference: imports rewritten to this folder, the native (C++)
# fast paths removed. It imports nothing of the program under test.
"""Evaluation schema AST (reference evaluation.rs).

`Schema` nodes mirror EvaluationQuerySchema::{Commitment,Eval,Scalar,Add,Mul}
with the cached has_commitment flag (evaluation.rs:14-38). `eval_prepare`
flattens the tree into (key, point, scalar) triples, deduplicating scalars by
commitment key (evaluation.rs:250-268) and pushing multiplied scalars down
(272-294); `eval` then performs ONE multi-exponentiation — the TPU hot path.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class CommitQuery:
    key: str
    commitment: object = None
    eval: object = None


class Schema:
    __slots__ = ("kind", "cq", "scalar_v", "a", "b", "has_commitment")

    K_COMMIT = 0
    K_EVAL = 1
    K_SCALAR = 2
    K_ADD = 3
    K_MUL = 4

    def __init__(self, kind, cq=None, scalar_v=None, a=None, b=None):
        self.kind = kind
        self.cq = cq
        self.scalar_v = scalar_v
        self.a = a
        self.b = b
        if kind == Schema.K_COMMIT:
            self.has_commitment = True
        elif kind in (Schema.K_EVAL, Schema.K_SCALAR):
            self.has_commitment = False
        else:
            self.has_commitment = a.has_commitment or b.has_commitment

    # constructors (commit!/eval!/scalar! macros, evaluation.rs:41-60)
    @staticmethod
    def commit(cq: CommitQuery) -> "Schema":
        return Schema(Schema.K_COMMIT, cq=cq)

    @staticmethod
    def eval_(cq: CommitQuery) -> "Schema":
        return Schema(Schema.K_EVAL, cq=cq)

    @staticmethod
    def scalar(s) -> "Schema":
        return Schema(Schema.K_SCALAR, scalar_v=s)

    def __add__(self, o: "Schema") -> "Schema":
        return Schema(Schema.K_ADD, a=self, b=o)

    def __mul__(self, o: "Schema") -> "Schema":
        return Schema(Schema.K_MUL, a=self, b=o)

    # -- evaluation (evaluation.rs:177-295) --------------------------------
    def eval(self, ctx, schip, pchip, one):
        """Returns (point, leftover_scalar_or_None, point_names)."""
        triples = self.eval_prepare(ctx, schip, one, None)
        names = [name for name, _p, _s in triples]
        leftover = None
        for name, _p, s in triples:
            if name == "":
                leftover = s
                break
        points, scalars = [], []
        extra_points = []
        msm_names = []
        for name, p, s in triples:
            if p is None:
                continue
            if s is None:
                extra_points.append(p)
            else:
                points.append(p)
                scalars.append(s)
                msm_names.append(name)
        acc = pchip.multi_exp(ctx, points, scalars, names=msm_names)
        for p in extra_points:
            acc = pchip.add(ctx, acc, p)
        return acc, leftover, names

    def eval_prepare(self, ctx, schip, one, scalar):
        """Flattens to deduplicated (key, point, scalar) triples.

        Same semantics as the reference's recursive merge (evaluation.rs:
        250-294: dedup scalars by commitment key, push multiplied scalars
        down) but accumulated into one insertion-ordered dict so the merge is
        O(terms) instead of O(terms^2) — the λ-RLC-folded aggregation AST has
        batch×queries terms and the quadratic scan dominated large batches.
        """
        acc: dict = {}
        self._prepare(ctx, schip, one, scalar, acc)
        return [(name, p, s) for name, (p, s) in acc.items()]

    @staticmethod
    def _insert(ctx, schip, one, acc, name, p, s):
        prev = acc.get(name)
        if prev is None:
            acc[name] = (p, s)
        else:
            p2, s2 = prev
            merged = schip.add(
                ctx,
                s2 if s2 is not None else one,
                s if s is not None else one,
            )
            acc[name] = (p2, merged)

    def _scalar_value(self, ctx, schip):
        """Value of a commitment-free subtree."""
        k = self.kind
        if k == Schema.K_EVAL:
            return self.cq.eval
        if k == Schema.K_SCALAR:
            return self.scalar_v
        if k == Schema.K_ADD:
            return schip.add(ctx, self.a._scalar_value(ctx, schip),
                             self.b._scalar_value(ctx, schip))
        if k == Schema.K_MUL:
            return schip.mul(ctx, self.a._scalar_value(ctx, schip),
                             self.b._scalar_value(ctx, schip))
        raise ValueError(k)

    def _prepare(self, ctx, schip, one, scalar, acc):
        k = self.kind
        if k == Schema.K_COMMIT:
            self._insert(ctx, schip, one, acc, self.cq.key, self.cq.commitment, scalar)
            return
        if k in (Schema.K_EVAL, Schema.K_SCALAR):
            v = self.cq.eval if k == Schema.K_EVAL else self.scalar_v
            if scalar is not None:
                v = schip.mul(ctx, scalar, v)
            self._insert(ctx, schip, one, acc, "", None, v)
            return
        if k == Schema.K_ADD:
            l, r = self.a, self.b
            if not l.has_commitment and not r.has_commitment:
                s = schip.add(ctx, l._scalar_value(ctx, schip),
                              r._scalar_value(ctx, schip))
                if scalar is not None:
                    s = schip.mul(ctx, scalar, s)
                self._insert(ctx, schip, one, acc, "", None, s)
                return
            l._prepare(ctx, schip, one, scalar, acc)
            r._prepare(ctx, schip, one, scalar, acc)
            return
        if k == Schema.K_MUL:
            l, r = self.a, self.b
            if not l.has_commitment:
                s_side, rem = l, r
            else:
                s_side, rem = r, l
            s = s_side._scalar_value(ctx, schip)
            if scalar is not None:
                s = schip.mul(ctx, scalar, s)
            rem._prepare(ctx, schip, one, s, acc)
            return
        raise ValueError(k)

    def estimate(self, with_scalar: bool = False) -> int:
        """Scalar-mul count estimate (evaluation.rs:297-331)."""
        k = self.kind
        if k == Schema.K_COMMIT:
            return 1
        if k in (Schema.K_EVAL, Schema.K_SCALAR):
            return 1 if with_scalar else 0
        if k == Schema.K_ADD:
            if not self.a.has_commitment and not self.b.has_commitment:
                base = self.a.estimate(False) + self.b.estimate(False)
                return base + 1 if with_scalar else base
            return self.a.estimate(with_scalar) + self.b.estimate(with_scalar)
        if k == Schema.K_MUL:
            return (self.b if not self.a.has_commitment else self.a).estimate(True)
        raise ValueError(k)


@dataclasses.dataclass
class EvaluationQuery:
    """A (rotation, point, schema) opening claim (evaluation.rs:92-126)."""

    rotation: int
    point: object
    s: Schema

    @staticmethod
    def new(rotation: int, key: str, point, commitment, eval_):
        cq = CommitQuery(key=key, commitment=commitment, eval=eval_)
        return EvaluationQuery(rotation, point, Schema.commit(cq) + Schema.eval_(cq))

    @staticmethod
    def new_from_query(rotation: int, point, s: Schema):
        return EvaluationQuery(rotation, point, s)


def print_points_profiling(point_list: list[str], log=None):
    """Rows-cost profiler (evaluation.rs:130-175): estimates aggregation-circuit
    rows at 32196 rows/ecmul and the minimum k."""
    import logging

    log = log or logging.getLogger(__name__)
    n = len(point_list)
    ecmul_rows = 32196
    rows = n * ecmul_rows
    k = 18
    while (1 << k) <= rows:
        k += 1
    log.debug("total ecmul: %d; rows %d; min k %d", n, rows, k)
    counts: dict[str, int] = {}
    for name in point_list:
        tag = name.split("_")[0] or "unknown"
        counts[tag] = counts.get(tag, 0) + 1
    for tag, cnt in sorted(counts.items()):
        log.debug("circuit %s: num %d (%.2f%%)", tag, cnt, cnt * 100.0 / max(n, 1))
    return k
