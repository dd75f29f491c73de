# Copy of halo2_snark_aggregator_tpu/circuits/lookup.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""Sample lookup circuit: advice values constrained to a fixed 16-entry table.

Workload analog of the reference's lookup_test
(api/src/tests/systems/halo2/lookup_test/test_circuit.rs): exercises the
permuted-lookup argument (degree 4 -> 3 quotient pieces) without any gates or
permutation columns.
"""

from __future__ import annotations

import dataclasses

from ..protocol.plonk import Circuit, ConstraintSystem


@dataclasses.dataclass
class LookupConfig:
    a: object
    table: object


class SimpleLookupCircuit(Circuit):
    K = 6
    TABLE_SIZE = 16

    def __init__(self, values: list[int] | None = None):
        self.values = values if values is not None else [1, 3, 5, 7, 11, 13]
        assert all(0 <= v < self.TABLE_SIZE for v in self.values)

    def configure(self, cs: ConstraintSystem) -> LookupConfig:
        a = cs.advice_column()
        table = cs.fixed_column()
        cs.lookup("range16", [(cs.query_advice(a, 0), cs.query_fixed(table, 0))])
        return LookupConfig(a, table)

    def synthesize(self, config: LookupConfig, assigner):
        for i in range(self.TABLE_SIZE):
            assigner.assign_fixed(config.table, i, i)
        for i, v in enumerate(self.values):
            assigner.assign_advice(config.a, i, v)

    def instances(self) -> list[list[int]]:
        return []
