"""The port's accelerated prover (prover/srs.py, prover/accel.py) on the CPU,
where every kernel wrapper runs its plain twin, against the JAX package's
host prover, its oracle:

  * `unsafe_setup_accel` equals `ParamsKZG.unsafe_setup` at k = 5 (points,
    Lagrange prefix, s_g2), also after a round trip through the cache;
  * `keygen_accel` equals the host `keygen` (vk, sigmas, fixed coefficients);
  * `create_proof_accel` writes the same bytes as the host `create_proof`
    on SimpleMul, SimpleLookup and the zkevm-shape circuit at k = 7, with
    host and with device commits, and the port's BatchedVerifier accepts
    the zkevm-shape proof.

Device commits here use MSM window 4, not the card's 8: the plain twin of
the bucket reduce walks the 2^c buckets one by one, and at c = 8 one
commit takes seconds on the CPU. The plan, kernels and combine are the
same code at either window.
"""

import pytest

from halo2_snark_aggregator_tpu.circuits.lookup import SimpleLookupCircuit
from halo2_snark_aggregator_tpu.circuits.simple import SimpleMulCircuit
from halo2_snark_aggregator_tpu.circuits.zkevm import ZkevmShapeCircuit
from halo2_snark_aggregator_tpu.prover.keygen import keygen
from halo2_snark_aggregator_tpu.prover.kzg import ParamsKZG
from halo2_snark_aggregator_tpu.prover.prove import create_proof
from halo2_snark_aggregator_tpu.transcript.host import PoseidonWrite
from halo2_snark_aggregator_tpu_torch.circuits import lookup as plookup
from halo2_snark_aggregator_tpu_torch.circuits import simple as psimple
from halo2_snark_aggregator_tpu_torch.circuits import zkevm as pzkevm
from halo2_snark_aggregator_tpu_torch.ops import curve as cv
from halo2_snark_aggregator_tpu_torch.protocol.batched import BatchedVerifier
from halo2_snark_aggregator_tpu_torch.prover import accel, srs
from halo2_snark_aggregator_tpu_torch.prover import kzg as pkzg
from halo2_snark_aggregator_tpu_torch.transcript import host as phost

CPU_WINDOW = 4


def _g2(pt):
    return tuple((c.c0, c.c1) for c in pt)


def test_srs_accel_matches_host(tmp_path):
    k = 5
    host = ParamsKZG.unsafe_setup(k)
    got = srs.unsafe_setup_accel(k, lagrange_prefix=1 << k, device="cpu")
    assert cv.to_affine_ints(got.g_dev.unbind(1)) == host.g
    assert got.g_lagrange == host.g_lagrange
    assert _g2(got.s_g2) == _g2(host.s_g2) and _g2(got.g2) == _g2(host.g2)
    first = srs.setup_cached_accel(k, cache_dir=tmp_path, device="cpu")
    again = srs.setup_cached_accel(k, cache_dir=tmp_path, device="cpu")
    assert [p.name for p in tmp_path.iterdir()] == [f"accel_params_k{k}.npz"]
    for a in (first, again):
        assert cv.to_affine_ints(a.g_dev.unbind(1)) == host.g
        assert a.g_lagrange[: 1 << k] == host.g_lagrange
        assert _g2(a.s_g2) == _g2(host.s_g2)


# (name, JAX circuit, port circuit, k)
CASES = {
    "simple_mul": (SimpleMulCircuit(), psimple.SimpleMulCircuit(),
                   SimpleMulCircuit.K),
    "simple_lookup": (SimpleLookupCircuit(), plookup.SimpleLookupCircuit(),
                      SimpleLookupCircuit.K),
    "zkevm_k7": (ZkevmShapeCircuit(k=7, seed=3, n_groups=2, table_bits=6),
                 pzkevm.ZkevmShapeCircuit(k=7, seed=3, n_groups=2,
                                          table_bits=6), 7),
}


@pytest.fixture(scope="module")
def keys():
    """Per case: the host (params, pk, vk) and the port's (params, apk, vk)
    from keygen_accel with host commits."""
    out = {}
    for name, (jc, pc, k) in CASES.items():
        params = ParamsKZG.unsafe_setup(k)
        vk, pk = keygen(jc, k, params)
        aparams = accel.AccelParams.from_params(pkzg.ParamsKZG.unsafe_setup(k),
                                                "host", device="cpu")
        avk, apk = accel.keygen_accel(pc, k, aparams)
        out[name] = (params, pk, vk, aparams, apk, avk)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_keygen_accel_matches_host(keys, name):
    _params, pk, vk, _aparams, apk, avk = keys[name]
    assert avk.transcript_repr() == vk.transcript_repr()
    assert avk.fixed_commitments == vk.fixed_commitments
    assert avk.permutation_commitments == vk.permutation_commitments
    for host_sig, acc_sig in zip(pk.sigmas_lagrange, apk.sigmas_lagrange):
        assert accel.mont_to_ints(acc_sig) == host_sig
    for host_fc, acc_fc in zip(pk.fixed_coeff, apk.fixed_coeff):
        assert accel.mont_to_ints(acc_fc) == host_fc


def test_keygen_accel_device_commits(keys):
    """keygen with device commits gives the same key; each commit's record
    splits its time into the five phases."""
    _params, _pk, vk, aparams, _apk, _avk = keys["simple_lookup"]
    dparams = accel.AccelParams.from_params(aparams.host, "device",
                                            device="cpu",
                                            msm_window=CPU_WINDOW)
    dparams.commit_log = []
    avk, _ = accel.keygen_accel(plookup.SimpleLookupCircuit(),
                                SimpleLookupCircuit.K, dparams)
    assert avk.transcript_repr() == vk.transcript_repr()
    assert dparams.commit_log
    for rec in dparams.commit_log:
        assert rec["mode"] == "device"
        assert list(rec["split_s"]) == ["scalars", "plan", "accumulate",
                                        "reduce", "combine"]
        assert sum(rec["split_s"].values()) <= rec["seconds"]


_PROOFS: dict = {}


@pytest.mark.parametrize("mode", ["host", "device"])
@pytest.mark.parametrize("name", list(CASES))
def test_proof_bit_exact(keys, name, mode):
    params, pk, _vk, aparams, apk, _avk = keys[name]
    jc, pc, _k = CASES[name]
    host_proof = create_proof(pk, params, [jc], [jc.instances()],
                              PoseidonWrite(), seed=7)
    if mode == "device":
        aparams = accel.AccelParams.from_params(aparams.host, "device",
                                                device="cpu",
                                                msm_window=CPU_WINDOW)
    timer = accel.StageTimer(aparams.device, True)
    proof = accel.create_proof_accel(apk, aparams, [pc], [pc.instances()],
                                     phost.PoseidonWrite(), seed=7,
                                     timer=timer)
    assert proof == host_proof
    assert set(timer.seconds) == {"other", "synthesis", "ntt", "commit",
                                  "quotient", "open"}
    _PROOFS[name] = proof


def test_batched_verifier_accepts_zkevm_proof(keys):
    _params, _pk, _vk, aparams, apk, avk = keys["zkevm_k7"]
    pc = CASES["zkevm_k7"][1]
    proof = _PROOFS.get("zkevm_k7") or accel.create_proof_accel(
        apk, aparams, [pc], [pc.instances()], phost.PoseidonWrite(), seed=7)
    bv = BatchedVerifier(avk, aparams, batch=1, sample_proof=proof,
                         sample_instances=pc.instances(),
                         msm_window=CPU_WINDOW, device="cpu")
    *_pair, ok = bv.verify([proof], [pc.instances()])
    assert ok
