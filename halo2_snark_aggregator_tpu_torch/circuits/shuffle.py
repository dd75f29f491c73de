# Copy of halo2_snark_aggregator_tpu/circuits/shuffle.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""Shuffle-argument sample circuit (reference E2, sdk/examples/shuffle.rs).

Proves that advice column `s` is a permutation of advice column `a` via a
challenge-based grand product: with a phase-1 challenge gamma,

    z[0] = 1,  z[i+1] * (s[i] + gamma) = z[i] * (a[i] + gamma),  z[m] = 1.

This is the workload that exercises halo2's multi-phase machinery end to end
(phase-1 advice columns and `challenge_usable_after`, the reference verifier's
multi-phase transcript replay at verify.rs:350-391): the z witness can only
be generated after the phase-0 commitments are absorbed and gamma squeezed.
"""

from __future__ import annotations

import dataclasses

from ..ff.bn254 import R
from ..protocol.plonk import Circuit, ConstraintSystem, Expression


@dataclasses.dataclass
class ShuffleConfig:
    a: object
    s: object
    z: object
    gamma: int  # challenge index
    q_step: object
    q_first: object
    q_last: object


class ShuffleCircuit(Circuit):
    K = 6

    def __init__(self, values: list[int] | None = None,
                 perm: list[int] | None = None):
        self.values = values if values is not None else [5, 1, 4, 2, 8, 2, 7]
        m = len(self.values)
        self.perm = perm if perm is not None else [(i * 3 + 1) % m for i in range(m)]
        assert sorted(self.perm) == list(range(m))
        self.shuffled = [self.values[j] for j in self.perm]

    def configure(self, cs: ConstraintSystem) -> ShuffleConfig:
        a = cs.advice_column(0)
        s = cs.advice_column(0)
        z = cs.advice_column(1)  # second-phase column
        gamma = cs.challenge_usable_after(0)
        q_step = cs.fixed_column()
        q_first = cs.fixed_column()
        q_last = cs.fixed_column()

        a_e = cs.query_advice(a, 0)
        s_e = cs.query_advice(s, 0)
        z_e = cs.query_advice(z, 0)
        z_next = cs.query_advice(z, 1)
        g_e = Expression.challenge(gamma)
        cs.create_gate("shuffle", [
            cs.query_fixed(q_first, 0) * (z_e - Expression.const(1)),
            cs.query_fixed(q_last, 0) * (z_e - Expression.const(1)),
            cs.query_fixed(q_step, 0)
            * (z_next * (s_e + g_e) - z_e * (a_e + g_e)),
        ])
        return ShuffleConfig(a, s, z, gamma, q_step, q_first, q_last)

    def synthesize(self, config: ShuffleConfig, assigner):
        m = len(self.values)
        assigner.assign_fixed(config.q_first, 0, 1)
        assigner.assign_fixed(config.q_last, m, 1)
        for i in range(m):
            assigner.assign_fixed(config.q_step, i, 1)
            assigner.assign_advice(config.a, i, self.values[i])
            assigner.assign_advice(config.s, i, self.shuffled[i])

        gamma = assigner.get_challenge(config.gamma)
        if gamma is None:
            return  # phase-0 pass / keygen: z unknown yet
        z = 1
        assigner.assign_advice(config.z, 0, z)
        for i in range(m):
            z = (z * (self.values[i] + gamma)
                 * pow((self.shuffled[i] + gamma) % R, -1, R)) % R
            assigner.assign_advice(config.z, i + 1, z)

    def instances(self) -> list[list[int]]:
        return []
