# Copy of halo2_snark_aggregator_tpu/circuits/synthetic.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""Synthetic large-circuit workload (the zkevm-bench analog, reference C9 /
A27 zkevm_test: a K=16..18 target circuit stressing every argument type).

The scroll zkEVM circuit itself is out of scope (it is a separate Rust
workspace the reference pulls as a dev-dependency); this family reproduces
its *workload shape* for the verifier/aggregator pipeline: multiple advice
columns, two custom gates on selector rows, a range lookup, long permutation
(copy) chains, and an instance column — at a configurable K so the same
circuit serves CPU tests (K=8) and TPU benches (K>=16, 2^16-point MSMs per
BASELINE.md config 3).
"""

from __future__ import annotations

import dataclasses

from ..ff.bn254 import R
from ..protocol.plonk import Circuit, ConstraintSystem


@dataclasses.dataclass
class SyntheticConfig:
    a: object
    b: object
    c: object
    q_mul: object
    q_add: object
    table: object
    instance: object


class SyntheticCircuit(Circuit):
    """rows_log2 controls the assigned region (~3/4 of 2^K rows used).

    Row i computes c = a*b (even i) or c = a+b (odd i); c chains into the
    next row's `a` by an equality copy; `b` is range-limited via a lookup
    into a 2^table_bits fixed table; the final chain value is exposed as the
    single public input.
    """

    def __init__(self, k: int = 8, seed: int = 1, table_bits: int = 6):
        self.K = k
        self.seed = seed
        self.table_bits = table_bits
        self.rows = (1 << k) * 3 // 4
        # deterministic pseudo-random b stream (small xorshift)
        s = (seed * 2654435761 + 1) & 0xFFFFFFFF
        self.b_vals = []
        for _ in range(self.rows):
            s ^= (s << 13) & 0xFFFFFFFF
            s ^= s >> 17
            s ^= (s << 5) & 0xFFFFFFFF
            self.b_vals.append(s & ((1 << table_bits) - 1))

    def configure(self, cs: ConstraintSystem) -> SyntheticConfig:
        a = cs.advice_column()
        b = cs.advice_column()
        c = cs.advice_column()
        q_mul = cs.fixed_column()
        q_add = cs.fixed_column()
        table = cs.fixed_column()
        instance = cs.instance_column()
        cs.enable_equality(a)
        cs.enable_equality(c)
        cs.enable_equality(instance)

        a_e, b_e, c_e = (cs.query_advice(col, 0) for col in (a, b, c))
        cs.create_gate("mul", [cs.query_fixed(q_mul, 0) * (a_e * b_e - c_e)])
        a_e, b_e, c_e = (cs.query_advice(col, 0) for col in (a, b, c))
        cs.create_gate("add", [cs.query_fixed(q_add, 0) * (a_e + b_e - c_e)])
        cs.lookup("b_range", [(cs.query_advice(b, 0), cs.query_fixed(table, 0))])
        return SyntheticConfig(a, b, c, q_mul, q_add, table, instance)

    def _trace(self):
        acc = (self.seed + 2) % R
        rows = []
        for i, bv in enumerate(self.b_vals):
            if i % 2 == 0:
                cv = acc * bv % R
            else:
                cv = (acc + bv) % R
            rows.append((acc, bv, cv))
            acc = cv
        return rows, acc

    def synthesize(self, config: SyntheticConfig, assigner):
        for t in range(1 << self.table_bits):
            assigner.assign_fixed(config.table, t, t)
        rows, _final = self._trace()
        for i, (av, bv, cv) in enumerate(rows):
            assigner.assign_advice(config.a, i, av)
            assigner.assign_advice(config.b, i, bv)
            assigner.assign_advice(config.c, i, cv)
            assigner.assign_fixed(config.q_mul if i % 2 == 0 else config.q_add,
                                  i, 1)
            if i + 1 < len(rows):
                assigner.copy(config.c, i, config.a, i + 1)
        # expose the final chain value
        assigner.copy(config.c, len(rows) - 1, config.instance, 0)

    def instances(self) -> list[list[int]]:
        _rows, final = self._trace()
        return [[final]]
