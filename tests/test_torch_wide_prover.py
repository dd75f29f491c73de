"""The port's prover at the width of the K=18 fixture's circuit
(`ZkevmShapeCircuit(n_groups=43)`: 131 phase-0 advice columns, one phase-1
column, 49 fixed columns, a permutation over 86 columns), on the CPU where
every kernel wrapper runs its plain twin, against the JAX package's host
prover:

  * `keygen_accel` equals the host `keygen` at k = 7 (table_bits 6);
  * `create_proof_accel` writes the host `create_proof`'s bytes, with host
    and with device commits (MSM window 4, as in tests/test_torch_prover.py);
  * the quotient program of the 43-group constraint system (the same at
    every k) stays within the row-program kernel's slots and under the 48 KB
    of shared memory above which it opts in to more; the aggregator's
    quotient columns, the base of the k = 22 working-set estimate
    (prove.py), are pinned against the reference's AggregatorCircuit.
"""

import numpy as np
import pytest

from halo2_snark_aggregator_tpu.circuits.aggregator import AggregatorCircuit
from halo2_snark_aggregator_tpu.circuits.zkevm import ZkevmShapeCircuit
from halo2_snark_aggregator_tpu.protocol.plonk import ConstraintSystem as JaxCS
from halo2_snark_aggregator_tpu.prover.keygen import keygen
from halo2_snark_aggregator_tpu.prover.kzg import ParamsKZG
from halo2_snark_aggregator_tpu.prover.prove import create_proof
from halo2_snark_aggregator_tpu.transcript.host import PoseidonWrite
from halo2_snark_aggregator_tpu_torch import prove as pprove
from halo2_snark_aggregator_tpu_torch.circuits import zkevm as pzkevm
from halo2_snark_aggregator_tpu_torch.ops import field as fo
from halo2_snark_aggregator_tpu_torch.protocol.plonk import ConstraintSystem
from halo2_snark_aggregator_tpu_torch.prover import accel
from halo2_snark_aggregator_tpu_torch.prover import kzg as pkzg
from halo2_snark_aggregator_tpu_torch.prover import quotient_program as qp
from halo2_snark_aggregator_tpu_torch.transcript import host as phost

K = 7
GROUPS = 43
CPU_WINDOW = 4


def _circuits(seed: int):
    kw = dict(k=K, seed=seed, n_groups=GROUPS, table_bits=6)
    return ZkevmShapeCircuit(**kw), pzkevm.ZkevmShapeCircuit(**kw)


@pytest.fixture(scope="module")
def wide():
    """The host key and proof (seed 7) and the port's key (host commits)."""
    jc, pc = _circuits(1)
    params = ParamsKZG.unsafe_setup(K)
    vk, pk = keygen(jc, K, params)
    aparams = accel.AccelParams.from_params(pkzg.ParamsKZG.unsafe_setup(K),
                                            "host", device="cpu")
    avk, apk = accel.keygen_accel(pc, K, aparams)
    jp, pp = _circuits(2)
    proof = create_proof(pk, params, [jp], [jp.instances()], PoseidonWrite(),
                         seed=7)
    return dict(params=params, pk=pk, vk=vk, aparams=aparams, apk=apk,
                avk=avk, circuit=pp, proof=proof)


def test_wide_keygen_matches_host(wide):
    vk, pk, avk, apk = wide["vk"], wide["pk"], wide["avk"], wide["apk"]
    assert vk.cs.num_advice_columns == 3 * GROUPS + 3
    assert len(vk.cs.permutation_columns) == 2 * GROUPS
    assert avk.transcript_repr() == vk.transcript_repr()
    assert avk.fixed_commitments == vk.fixed_commitments
    assert avk.permutation_commitments == vk.permutation_commitments
    for host_sig, acc_sig in zip(pk.sigmas_lagrange, apk.sigmas_lagrange):
        assert accel.mont_to_ints(acc_sig) == host_sig


@pytest.mark.parametrize("mode", ["host", "device"])
def test_wide_proof_bit_exact(wide, mode):
    aparams = wide["aparams"]
    if mode == "device":
        aparams = accel.AccelParams.from_params(aparams.host, "device",
                                                device="cpu",
                                                msm_window=CPU_WINDOW)
    pc = wide["circuit"]
    timer = accel.StageTimer(aparams.device, True)
    proof = accel.create_proof_accel(wide["apk"], aparams, [pc],
                                     [pc.instances()], phost.PoseidonWrite(),
                                     seed=7, timer=timer)
    assert proof == wide["proof"]
    # the peak bytes are a device reading: none on the CPU
    assert timer.peak_bytes == {}


def _program_smem(prog) -> int:
    """The row-program kernel's shared memory (csrc/field.cu
    h2t_field_program): 16 B an instruction, 8 a reference, 32 a constant."""
    return len(prog.code) * 16 + len(prog.refs) * 8 + len(prog.consts) * 32


@pytest.mark.parametrize("groups,want", [
    (8, (325, 97, 22, 76, 6)),      # the K=16 fixture's key
    (43, (1375, 412, 92, 321, 6)),  # the K=18 fixture's key
])
def test_wide_quotient_program_fits(groups, want):
    """(instructions, column references, constants, columns, slots) of one
    proof's quotient program, with challenges drawn from a seed."""
    cs = ConstraintSystem()
    pzkevm.ZkevmShapeCircuit(k=18, seed=1, n_groups=groups).configure(cs)
    rng = np.random.default_rng(groups)
    ch = [int.from_bytes(rng.bytes(31), "little") for _ in range(4 + cs.num_challenges)]
    prog, keys = qp.compile_quotient(cs, 1, ch[4:], *ch[:4])
    got = (len(prog.code), len(prog.refs), len(prog.consts), len(keys),
           prog.n_slots)
    assert got == want
    assert prog.n_slots <= fo.PROGRAM_SLOTS
    assert _program_smem(prog) <= 48 * 1024


def test_aggregator_quotient_columns():
    """The k = 22 aggregator's constraint system (reference
    circuits/aggregator.py configure) reads this many distinct columns in
    its quotient, the count prove.py scales the K=18 working set by."""
    cs = JaxCS()
    AggregatorCircuit([]).configure(cs)
    assert (cs.num_advice_columns, cs.num_fixed_columns,
            cs.num_instance_columns, len(cs.permutation_columns),
            len(cs.lookups), cs.degree()) == (5, 14, 1, 6, 4, 5)
    _prog, keys = qp.compile_quotient(cs, 1, [], 1, 2, 3, 4)
    assert len(keys) == pprove.AGG_QUOTIENT_COLUMNS
