# Copy of halo2_snark_aggregator_tpu/circuits/simple.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""Sample target circuit: out = a * b * constant (public: out).

Workload analog of the reference's add_mul test circuit / simple-example
(api/src/tests/systems/halo2/add_mul_test/test_circuit.rs): two advice
columns, one instance column, fixed constant column, fixed mul-selector, one
mul gate a0*a1 = a0.next, equality constraints across advice/instance/fixed.
"""

from __future__ import annotations

import dataclasses

from ..ff.bn254 import R
from ..protocol.plonk import Circuit, ConstraintSystem


@dataclasses.dataclass
class SimpleConfig:
    a0: object
    a1: object
    instance: object
    constant: object
    s_mul: object


class SimpleMulCircuit(Circuit):
    """Witness: private a, b; fixed constant k; public output a*b*k."""

    K = 6
    CONSTANT = 7

    def __init__(self, a: int = 2, b: int = 3):
        self.a = a % R
        self.b = b % R

    def public_output(self) -> int:
        return self.a * self.b % R * self.CONSTANT % R

    def instances(self) -> list[list[int]]:
        return [[self.public_output()]]

    def configure(self, cs: ConstraintSystem) -> SimpleConfig:
        a0 = cs.advice_column()
        a1 = cs.advice_column()
        instance = cs.instance_column()
        constant = cs.fixed_column()
        s_mul = cs.fixed_column()

        cs.enable_equality(instance)
        cs.enable_equality(a0)
        cs.enable_equality(a1)
        cs.enable_equality(constant)

        lhs = cs.query_advice(a0, 0)
        rhs = cs.query_advice(a1, 0)
        out = cs.query_advice(a0, 1)
        sel = cs.query_fixed(s_mul, 0)
        cs.create_gate("mul", [sel * (lhs * rhs - out)])

        return SimpleConfig(a0, a1, instance, constant, s_mul)

    def synthesize(self, config: SimpleConfig, assigner):
        a, b, k = self.a, self.b, self.CONSTANT
        ab = a * b % R
        out = ab * k % R

        # row 0: a * b -> row 1
        assigner.assign_advice(config.a0, 0, a)
        assigner.assign_advice(config.a1, 0, b)
        assigner.assign_fixed(config.s_mul, 0, 1)
        assigner.assign_advice(config.a0, 1, ab)
        # row 1: ab * k -> row 2
        assigner.assign_advice(config.a1, 1, k)
        assigner.assign_fixed(config.s_mul, 1, 1)
        assigner.assign_advice(config.a0, 2, out)
        # fixed constant cell + equality to the advice copy of k
        assigner.assign_fixed(config.constant, 0, k)
        assigner.copy(config.constant, 0, config.a1, 1)
        # expose the output: out cell == instance[0]
        assigner.copy(config.a0, 2, config.instance, 0)
