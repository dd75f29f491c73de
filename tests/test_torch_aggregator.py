"""The port's aggregation circuit (circuits/aggregator.py, gadgets/,
arith/circuit.py) and MockProver (prover/mock.py) against the JAX package,
over one SimpleMul proof (the setup of tests/test_aggregator_circuit.py):

  * the public-input vector equals the JAX package's;
  * synthesized at K=22, the advice, fixed and instance columns and the
    copy list equal the JAX package's (per-column digests);
  * the port's MockProver is satisfied, and a tampered instance fails with
    a copy failure;
  * the aggregator's quotient row program fits the row-program kernel.

One synthesis per package serves every case (~30 s each on a CPU).
"""

import numpy as np
import pytest

from halo2_snark_aggregator_tpu.circuits import aggregator as jagg
from halo2_snark_aggregator_tpu.circuits.simple import SimpleMulCircuit
from halo2_snark_aggregator_tpu.prover.keygen import keygen
from halo2_snark_aggregator_tpu.prover.kzg import ParamsKZG
from halo2_snark_aggregator_tpu.prover.mock import MockProver as JaxMockProver
from halo2_snark_aggregator_tpu.prover.prove import create_proof
from halo2_snark_aggregator_tpu.transcript.host import PoseidonWrite
from halo2_snark_aggregator_tpu_torch.circuits import aggregator as pagg
from halo2_snark_aggregator_tpu_torch.circuits import simple as psimple
from halo2_snark_aggregator_tpu_torch.ops import field as fo
from halo2_snark_aggregator_tpu_torch.protocol.plonk import ConstraintSystem
from halo2_snark_aggregator_tpu_torch.prover import keygen as pkeygen
from halo2_snark_aggregator_tpu_torch.prover import kzg as pkzg
from halo2_snark_aggregator_tpu_torch.prover import quotient_program as qp
from halo2_snark_aggregator_tpu_torch.prover.mock import MockProver

AGG_K = 22


def _digests(assignment) -> dict:
    """Lengths and hashes of every column and of the copy list (Column is a
    frozen dataclass of (kind, index): it hashes alike in both packages)."""
    def digest(vals):
        return len(vals), hash(tuple(vals))

    return {"advice": [digest(c) for c in assignment.advice],
            "fixed": [digest(c) for c in assignment.fixed],
            "instance": [digest(c) for c in assignment.instances],
            "copies": digest(assignment.copies)}


@pytest.fixture(scope="module")
def synthesized():
    """The JAX aggregator's instances and K=22 assignment digests, and the
    port's aggregator with its MockProver (one synthesis each)."""
    k = SimpleMulCircuit.K
    params = ParamsKZG.unsafe_setup(k)
    c = SimpleMulCircuit(3, 5)
    vk, pk = keygen(c, k, params)
    proof = create_proof(pk, params, [c], [c.instances()], PoseidonWrite(), seed=0)
    jtarget = jagg.VerifierCircuitTarget(
        name="simple", vk=vk, params=params,
        proofs=[jagg.SingleProofWitness(instances=c.instances(), transcript=proof)])
    jax_agg = jagg.AggregatorCircuit([jtarget])
    jax_instances = jax_agg.instances()
    jax_digests = _digests(JaxMockProver(jax_agg, AGG_K, jax_instances).assignment)

    pparams = pkzg.ParamsKZG.unsafe_setup(k)
    pc = psimple.SimpleMulCircuit(3, 5)
    pvk, _ppk = pkeygen.keygen(pc, k, pparams)
    ptarget = pagg.VerifierCircuitTarget(
        name="simple", vk=pvk, params=pparams,
        proofs=[pagg.SingleProofWitness(instances=pc.instances(), transcript=proof)])
    agg = pagg.AggregatorCircuit([ptarget])
    instances = agg.instances()
    mp = MockProver(agg, AGG_K, instances)
    return dict(jax_instances=jax_instances, jax_digests=jax_digests, agg=agg,
                instances=instances, mp=mp, public_output=pc.public_output())


def test_instances_match_reference(synthesized):
    got = synthesized["instances"]
    assert got == synthesized["jax_instances"]
    assert len(got[0]) == 5
    assert got[0][4] == synthesized["public_output"]


def test_assignment_matches_reference(synthesized):
    mp = synthesized["mp"]
    assert _digests(mp.assignment) == synthesized["jax_digests"]
    assert len(mp.assignment.copies) > 0
    assert synthesized["agg"].row_usage["base"] < (1 << AGG_K)


def test_mock_prover_satisfied_and_tamper_fails(synthesized):
    mp = synthesized["mp"]
    mp.assert_satisfied()
    inst = mp.assignment.instances[0]
    saved = inst[4]
    inst[4] = saved + 1
    mp._col_cache.clear()
    try:
        failures = mp.verify()
    finally:
        inst[4] = saved
        mp._col_cache.clear()
    assert any(f.kind == "copy" for f in failures)


def test_aggregator_quotient_program_fits():
    """(instructions, column references, constants, columns, slots) of the
    aggregator's quotient program, within the row-program kernel's slots
    and 48 KB of shared memory (csrc/field.cu h2t_field_program: 16 B an
    instruction, 8 a reference, 32 a constant)."""
    cs = ConstraintSystem()
    pagg.AggregatorCircuit([]).configure(cs)
    assert (cs.num_advice_columns, cs.num_fixed_columns,
            cs.num_instance_columns, len(cs.permutation_columns),
            len(cs.lookups), cs.degree()) == (5, 14, 1, 6, 4, 5)
    rng = np.random.default_rng(22)
    ch = [int.from_bytes(rng.bytes(31), "little") for _ in range(4)]
    prog, keys = qp.compile_quotient(cs, 1, [], *ch)
    got = (len(prog.code), len(prog.refs), len(prog.consts), len(keys),
           prog.n_slots)
    assert got == (213, 56, 10, 44, 5)
    assert prog.n_slots <= fo.PROGRAM_SLOTS
    smem = len(prog.code) * 16 + len(prog.refs) * 8 + len(prog.consts) * 32
    assert smem <= 48 * 1024

