"""The port's copies of the shuffle circuit (circuits/shuffle.py, the
reference's multi-phase sdk/examples/shuffle.rs) and the synthetic
zkevm-bench family (circuits/synthetic.py) through the port's accelerated
prover on the CPU, where every kernel wrapper runs its plain twin: each
proof is byte-equal to the JAX host `create_proof` with the same seed
(the counterparts of tests/test_shuffle_e2e.py and
tests/test_synthetic_circuit.py), and the port's value chips accept it and
reject a wrong public input. The scalar AST (arith/ast.py) evaluates a
formula on the port's value chip as the reference's does."""

import pytest

from halo2_snark_aggregator_tpu.arith import ast as jast
from halo2_snark_aggregator_tpu.arith.value import ValueContext as JValueContext
from halo2_snark_aggregator_tpu.arith.value import ValueEccChip as JValueEccChip
from halo2_snark_aggregator_tpu.circuits.shuffle import ShuffleCircuit
from halo2_snark_aggregator_tpu.circuits.synthetic import SyntheticCircuit
from halo2_snark_aggregator_tpu.prover.keygen import keygen
from halo2_snark_aggregator_tpu.prover.kzg import ParamsKZG
from halo2_snark_aggregator_tpu.prover.prove import create_proof
from halo2_snark_aggregator_tpu.transcript.host import PoseidonWrite
from halo2_snark_aggregator_tpu_torch.arith import ast as past
from halo2_snark_aggregator_tpu_torch.arith.value import ValueContext, ValueEccChip
from halo2_snark_aggregator_tpu_torch.circuits import shuffle as pshuffle
from halo2_snark_aggregator_tpu_torch.circuits import synthetic as psynthetic
from halo2_snark_aggregator_tpu_torch.protocol import verify as pv
from halo2_snark_aggregator_tpu_torch.protocol.transcript import PoseidonTranscriptRead
from halo2_snark_aggregator_tpu_torch.prover import accel
from halo2_snark_aggregator_tpu_torch.prover import kzg as pkzg
from halo2_snark_aggregator_tpu_torch.transcript import host as phost

# name: (JAX circuit, port circuit, k, proof seed)
CASES = {
    "shuffle_k6": (lambda: ShuffleCircuit(), lambda: pshuffle.ShuffleCircuit(),
                   ShuffleCircuit.K, 5),
    "synthetic_k8": (lambda: SyntheticCircuit(k=8, seed=5),
                     lambda: psynthetic.SyntheticCircuit(k=8, seed=5), 8, 4),
}


def _verify(vk, params, instances, proof) -> bool:
    ctx = ValueContext()
    pchip = ValueEccChip()
    nchip = schip = pchip.scalar_chip
    cp = pv.CircuitProof(
        name="t", vk=vk, params=params,
        proofs=[pv.ProofData(instances=[instances],
                             transcript=PoseidonTranscriptRead(proof, ctx, nchip),
                             key="p0")])
    *_, ok = pv.verify_single_proof_in_chip(ctx, nchip, schip, pchip, cp)
    return ok


@pytest.mark.parametrize("name", sorted(CASES))
def test_proof_bit_exact_and_verifies(name):
    jbuild, pbuild, k, seed = CASES[name]
    params = ParamsKZG.unsafe_setup(k)
    jc = jbuild()
    _vk, pk = keygen(jc, k, params)
    host_proof = create_proof(pk, params, [jc], [jc.instances()],
                              PoseidonWrite(), seed=seed)

    pparams = pkzg.ParamsKZG.unsafe_setup(k)
    aparams = accel.AccelParams.from_params(pparams, device="cpu")
    pc = pbuild()
    avk, apk = accel.keygen_accel(pc, k, aparams)
    proof = accel.create_proof_accel(apk, aparams, [pc], [pc.instances()],
                                     phost.PoseidonWrite(), seed=seed)
    assert proof == host_proof
    assert _verify(avk, pparams, pc.instances(), proof)
    if pc.instances():
        bad = [[pc.instances()[0][0] + 1]]
        assert not _verify(avk, pparams, bad, proof)


def test_ast_matches_reference():
    """(a * (b - c) + a / b) over the value chips of both packages."""
    a, b, c = 7, 11, 5
    jctx, jchip = JValueContext(), JValueEccChip().scalar_chip
    pctx, pchip = ValueContext(), ValueEccChip().scalar_chip
    want = (jast.V(a) * (jast.V(b) - c) + jast.V(a) / b).eval(jctx, jchip)
    got = (past.V(a) * (past.V(b) - c) + past.V(a) / b).eval(pctx, pchip)
    assert got == want
