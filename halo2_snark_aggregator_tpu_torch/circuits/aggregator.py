# Copy of halo2_snark_aggregator_tpu/circuits/aggregator.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""The aggregation circuit (reference C2, halo2-snark-aggregator-circuit/src/
verify_circuit.rs:66-504): a halo2 circuit whose satisfying assignment runs
`verify_aggregation_proofs_in_chip` in the CIRCUIT context — the same
protocol engine that verifies on values emits base-gate/range-gate/ECC
constraints, producing a proof that N inner proofs verify.

Layout mirrors the reference:
  - configure  = five-column base gate + range gate + one equality-enabled
    instance column (verify_circuit.rs:225-241)
  - synthesize = init range tables, run the aggregation verifier with the
    circuit chips (380-504), coherence equality-constraints between listed
    advice commitments (487-493), assert the final pair is not the identity
    (495-496), reduce w_x/w_g, extract y-parity bits, pack each x-coordinate
    into two 136-bit cells (264-353), expose 4 + sum(inner instances) public
    inputs (355-368).

The public-input vector is produced host-side by the VALUE context run of the
same engine (`calc_verify_circuit_final_pair`, verify_circuit.rs:103-201) and
must match the in-circuit packing bit-for-bit (protocol/instances.py).
"""

from __future__ import annotations

import dataclasses

from ..arith.circuit import CircuitEccChip, CircuitFieldChip
from ..arith.value import ValueContext, ValueEccChip
from ..ff import bn254 as ff
from ..gadgets.base_gate import BaseGate, Context
from ..gadgets.ecc_chip import EccChip as GadgetEccChip
from ..gadgets.integer_chip import FQ_OVER_FR, IntegerChip
from ..gadgets.range_gate import RangeGate
from ..protocol import verify as pv
from ..protocol.instances import final_pair_to_instances
from ..protocol.plonk import Circuit, ConstraintSystem
from ..protocol.transcript import PoseidonTranscriptRead

COMMON_RANGE_BITS = 17  # verify_circuit.rs:64


@dataclasses.dataclass
class SingleProofWitness:
    """One inner proof: instance values + transcript bytes
    (reference SingleProofWitness, verify_circuit.rs:66-74)."""

    instances: list  # [column][row]
    transcript: bytes


@dataclasses.dataclass
class VerifierCircuitTarget:
    """One target-circuit group (reference Halo2VerifierCircuit fields)."""

    name: str
    vk: object
    params: object
    proofs: list[SingleProofWitness]


@dataclasses.dataclass
class AggregatorConfig:
    base: object
    range: object
    instance: object


class AggregatorCircuit(Circuit):
    """Halo2VerifierCircuit(s) analog. `coherent` lists pairs
    [(proof_idx, commitment_idx), (proof_idx, commitment_idx)] of advice
    commitments to equality-constrain across proofs (verify_circuit.rs:487-493).
    """

    def __init__(self, circuits: list[VerifierCircuitTarget],
                 coherent: list | None = None,
                 range_bits: int = COMMON_RANGE_BITS):
        self.circuits = circuits
        self.coherent = coherent or []
        self.range_bits = range_bits

    # -- host-side final pair + instance vector (C3/C4) ---------------------
    def _build_circuit_proofs(self, ctx, nchip):
        proofs = []
        for target in self.circuits:
            pds = []
            for i, pw in enumerate(target.proofs):
                t = PoseidonTranscriptRead(pw.transcript, ctx, nchip)
                pds.append(pv.ProofData(
                    instances=[pw.instances], transcript=t,
                    key=f"{target.name}_p{i}"))
            proofs.append(pv.CircuitProof(
                name=target.name, vk=target.vk, params=target.params,
                proofs=pds))
        return proofs

    def calc_final_pair(self):
        """Run the aggregation on the VALUE context
        (calc_verify_circuit_final_pair, verify_circuit.rs:103-201)."""
        ctx = ValueContext()
        pchip = ValueEccChip()
        nchip = schip = pchip.scalar_chip
        circuits = self._build_circuit_proofs(ctx, nchip)
        agg_transcript = PoseidonTranscriptRead(b"", ctx, nchip)
        w_x, w_g, plain, _commits, ok = pv.verify_aggregation_proofs_in_chip(
            ctx, nchip, schip, pchip, circuits, agg_transcript)
        if not ok:
            raise RuntimeError("aggregation pairing check failed on values")
        return w_x, w_g, plain

    def instances(self) -> list[list[int]]:
        """Public-input vector (final_pair_to_instances parity,
        verify_circuit.rs:768-825)."""
        w_x, w_g, plain = self.calc_final_pair()
        return [final_pair_to_instances(w_x, w_g, plain)]

    # -- circuit ------------------------------------------------------------
    def configure(self, cs: ConstraintSystem) -> AggregatorConfig:
        base = BaseGate.configure(cs)
        rng = RangeGate.configure(cs, self.range_bits, base)
        instance = cs.instance_column()
        cs.enable_equality(instance)
        return AggregatorConfig(base, rng, instance)

    def synthesize(self, config: AggregatorConfig, assigner):
        gate = BaseGate(config.base)
        rgate = RangeGate(config.range, gate)
        rgate.init_table(assigner)
        integer = IntegerChip(gate, rgate, FQ_OVER_FR)
        gadget = GadgetEccChip(integer, curve_b=ff.G1_B, scalar_bits=254)
        pchip = CircuitEccChip(gadget)
        nchip = schip = pchip.scalar_chip
        ctx = Context(assigner)

        circuits = self._build_circuit_proofs(ctx, nchip)
        agg_transcript = PoseidonTranscriptRead(b"", ctx, nchip)
        w_x, w_g, plain, commits, ok = pv.verify_aggregation_proofs_in_chip(
            ctx, nchip, schip, pchip, circuits, agg_transcript)
        assert ok, "in-circuit witness generation saw a failing pairing check"

        # coherence constraints between advice commitments (487-493)
        for (pa, ca), (pb, cb) in self.coherent:
            gadget.assert_equal(ctx, commits[pa][ca], commits[pb][cb])

        # the folded pair must not be the identity (495-496)
        gate.assert_false(ctx, w_x.z)
        gate.assert_false(ctx, w_g.z)

        # reduce + pack (264-353)
        w_x = pchip.normalize(ctx, w_x)
        w_g = pchip.normalize(ctx, w_g)
        y0_bit = integer.get_last_bit(ctx, w_x.y)
        y1_bit = integer.get_last_bit(ctx, w_g.y)

        lb = integer.f.limb_bits
        shift1 = pow(2, lb, ff.R)
        shift2 = pow(2, 2 * lb, ff.R)
        packed = []
        for pt, ybit in ((w_x, y0_bit), (w_g, y1_bit)):
            lo = gate.sum_with_coeff_and_constant(
                ctx, [(pt.x.limbs[0], 1), (pt.x.limbs[1], shift1)], 0)
            hi = gate.sum_with_coeff_and_constant(
                ctx, [(pt.x.limbs[2], 1), (pt.x.limbs[3], shift1),
                      (ybit, shift2)], 0)
            packed.extend([lo, hi])

        # expose public inputs (355-368): 4 packed cells + inner instances
        adv_cols = gate.config.advice
        row = 0
        for cell in packed + list(plain):
            assigner.copy(adv_cols[cell.col], cell.row, config.instance, row)
            row += 1

        # row-usage accounting: lets callers derive min k and lets the
        # constraint checker skip the untouched (all-default-zero) tail
        self.row_usage = {
            "base": ctx.offset,
            "table": 1 << self.range_bits,
        }
        assigner.used_rows_hint = max(self.row_usage.values()) + 2
