"""The port's hybrid chips (arith/device_value.py) and SDK stages
(sdk/harness.py, sdk/cli.py) on the CPU, where every kernel wrapper runs
its plain twin, against the JAX package:

  * `verify_aggregation_proofs_in_chip` over `make_device_chips("cpu",
    device_min=0)`, every MSM through `ops/msm.msm_ints`, gives the JAX
    value context's pair on SimpleMul x 2 and on the zkevm-shape circuit
    at k = 7;
  * the port's CLI with `--cpu` writes the same proof bytes, instances and
    final pair as the JAX CLI (sample_setup, sample_run, verify_check
    --cpu), and every file it writes loads with no card and no JAX;
  * the keygen checkpoint round-trips, is refused for another aggregator
    shape, other target vks or another stored vkey, and a leftover temp
    file is never loaded;
  * without `--cpu` and without a card a stage raises;
  * the second recursion layer's glue: verify_check_l1_poseidon accepts a
    stored Poseidon-transcript proof and rejects a flipped byte with the
    JAX verifier's verdict; the layer-2 target equals the JAX one;
  * verify_solidity over a stored outer proof refuses keccak256 with the
    JAX CLI's exit.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from halo2_snark_aggregator_tpu.arith.value import ValueContext, ValueEccChip
from halo2_snark_aggregator_tpu.circuits.simple import SimpleMulCircuit
from halo2_snark_aggregator_tpu.circuits.zkevm import ZkevmShapeCircuit
from halo2_snark_aggregator_tpu.protocol import verify as jpv
from halo2_snark_aggregator_tpu.protocol.transcript import PoseidonTranscriptRead
from halo2_snark_aggregator_tpu.prover.keygen import keygen
from halo2_snark_aggregator_tpu.prover.kzg import ParamsKZG
from halo2_snark_aggregator_tpu.prover.prove import create_proof
from halo2_snark_aggregator_tpu.sdk import cli as jcli
from halo2_snark_aggregator_tpu.transcript.host import PoseidonWrite
from halo2_snark_aggregator_tpu_torch import fixtures
from halo2_snark_aggregator_tpu_torch.arith.device_value import (
    DEVICE_MIN, DeviceEccChip, make_device_chips)
from halo2_snark_aggregator_tpu_torch.circuits import simple as psimple
from halo2_snark_aggregator_tpu_torch.circuits import zkevm as pzkevm
from halo2_snark_aggregator_tpu_torch.protocol import verify as ppv
from halo2_snark_aggregator_tpu_torch.protocol import transcript as ptr
from halo2_snark_aggregator_tpu_torch.protocol.instances import (
    compute_verify_public_input_size)
from halo2_snark_aggregator_tpu_torch.protocol.queryplan import (query_plan,
                                                                 rotation_sets)
from halo2_snark_aggregator_tpu_torch.prover import accel, srs
from halo2_snark_aggregator_tpu_torch.prover import keygen as pkeygen
from halo2_snark_aggregator_tpu_torch.prover import kzg as pkzg
from halo2_snark_aggregator_tpu_torch.sdk import cli as pcli
from halo2_snark_aggregator_tpu_torch.sdk import harness
from halo2_snark_aggregator_tpu_torch.utils.store import FolderStore

# w_x.x of the JAX CLI's demo (two SimpleMul proofs at K=6)
DEMO_W_X = 6319918070496538133486966131488885619156353575769957183046386625957580271050

# (JAX circuit builder, port circuit builder, k): two proofs a case
HYBRID_CASES = {
    "simple_mul_x2": (lambda s: SimpleMulCircuit(2 + s, 3 + s),
                      lambda s: psimple.SimpleMulCircuit(2 + s, 3 + s),
                      SimpleMulCircuit.K),
    "zkevm_k7": (lambda s: ZkevmShapeCircuit(k=7, seed=3 + s, n_groups=2,
                                             table_bits=6),
                 lambda s: pzkevm.ZkevmShapeCircuit(k=7, seed=3 + s, n_groups=2,
                                                    table_bits=6), 7),
}


def _aggregate(pv, read, params, vk, proofs, insts, chips):
    ctx, nchip, schip, pchip = chips
    pdata = [pv.ProofData(instances=[inst], transcript=read(p, ctx, nchip),
                          key=f"p{i}")
             for i, (p, inst) in enumerate(zip(proofs, insts))]
    cp = pv.CircuitProof(name="t", vk=vk, params=params, proofs=pdata)
    w_x, w_g, _plain, _commits, ok = pv.verify_aggregation_proofs_in_chip(
        ctx, nchip, schip, pchip, [cp], read(b"", ctx, nchip))
    return w_x, w_g, ok


@pytest.mark.parametrize("case", sorted(HYBRID_CASES))
def test_hybrid_pair_matches_value_context(case):
    jbuild, pbuild, k = HYBRID_CASES[case]
    params = ParamsKZG.unsafe_setup(k)
    vk, pk = keygen(jbuild(0), k, params)
    proofs, insts = [], []
    for i in range(2):
        c = jbuild(i + 1)
        proofs.append(create_proof(pk, params, [c], [c.instances()],
                                   PoseidonWrite(), seed=i))
        insts.append(c.instances())
    pchip = ValueEccChip()
    want = _aggregate(jpv, PoseidonTranscriptRead, params, vk, proofs, insts,
                      (ValueContext(), pchip.scalar_chip, pchip.scalar_chip,
                       pchip))
    assert want[2]

    pparams = pkzg.ParamsKZG.unsafe_setup(k)
    pvk, _ppk = pkeygen.keygen(pbuild(0), k, pparams)
    chips = make_device_chips("cpu", device_min=0)
    got = _aggregate(ppv, ptr.PoseidonTranscriptRead, pparams, pvk, proofs,
                     insts, chips)
    assert got == want
    ctx, pchip = chips[0], chips[3]
    assert pchip.device_msms == len(ctx.msm_sizes) > 0


def test_device_min_override(monkeypatch):
    """H2T_MSM_DEVICE_MIN overrides the measured crossover; an explicit
    `device_min` overrides both."""
    monkeypatch.setenv("H2T_MSM_DEVICE_MIN", "77")
    assert DeviceEccChip("cpu").device_min == 77
    assert DeviceEccChip("cpu", device_min=5).device_min == 5
    monkeypatch.delenv("H2T_MSM_DEVICE_MIN")
    assert DeviceEccChip("cpu").device_min == DEVICE_MIN


def test_outer_instances_fit_lagrange_prefix():
    """The outer proof's instance column (4 packed final-pair cells + the
    demos' public inputs) is committed with the accelerated SRS's Lagrange
    prefix, which covers it."""
    import inspect

    prefix = inspect.signature(srs.unsafe_setup_accel).parameters[
        "lagrange_prefix"].default
    for demo in ("simple", "multi"):
        assert compute_verify_public_input_size(pcli.demo_specs(demo)) == 6
        assert 6 <= prefix == 4096


STRICT_LOAD = r"""
import pickle, sys
sys.modules["jax"] = None          # importing jax now fails
class Strict(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in ("torch", "jax", "halo2_snark_aggregator_tpu"):
            raise pickle.UnpicklingError(f"{module}.{name}")
        return super().find_class(module, name)
for path in sys.argv[1:]:
    with open(path, "rb") as f:
        Strict(f).load()
print("loaded", len(sys.argv) - 1)
"""


def test_cli_matches_reference(tmp_path):
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    for cmd in ("sample_setup", "sample_run", "verify_check"):
        assert jcli.main(["-c", cmd, "-f", str(jdir), "--cpu"]) == 0
        assert pcli.main(["-c", cmd, "-f", str(pdir), "--cpu"]) == 0
    jstore, pstore = FolderStore(jdir), FolderStore(pdir)
    for i in range(2):
        assert (pstore.read_target_proof("simple", i)
                == jstore.read_target_proof("simple", i))
        assert (pstore.read_target_instance("simple", i)
                == jstore.read_target_instance("simple", i))
    pair = pstore.read_final_pair()
    assert pair == jstore.read_final_pair()
    assert pair[0][0] == DEMO_W_X
    assert sorted(p.name for p in pdir.iterdir()) == sorted(
        p.name for p in jdir.iterdir())

    # every pickle the port wrote loads with no card, no torch class and
    # no JAX package
    pickles = [str(p) for p in sorted(pdir.iterdir()) if "proof" not in p.name]
    assert len(pickles) == 5
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", STRICT_LOAD, *pickles],
                         cwd=Path(__file__).resolve().parent.parent, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "loaded 5"


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_stage_without_card_raises(tmp_path):
    """No fallback hides a missing card: a stage without --cpu raises."""
    for cmd in ("sample_setup", "verify_setup", "verify_check"):
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            pcli.main(["-c", cmd, "-f", str(tmp_path)])


@pytest.fixture(scope="module")
def k6_key():
    """A K=6 SimpleMul AccelPk on the CPU and its vk."""
    k = psimple.SimpleMulCircuit.K
    aparams = accel.AccelParams.from_params(pkzg.ParamsKZG.unsafe_setup(k),
                                            device="cpu")
    return accel.keygen_accel(psimple.SimpleMulCircuit(2, 3), k, aparams)


def _same_pk(a, b):
    for key in ("fixed_lagrange", "fixed_coeff", "sigmas_lagrange",
                "sigmas_coeff"):
        ca, cb = getattr(a, key), getattr(b, key)
        assert len(ca) == len(cb) > 0
        assert all(torch.equal(x, y) for x, y in zip(ca, cb))


def test_checkpoint_round_trip(tmp_path, k6_key):
    vk, apk = k6_key
    store = FolderStore(tmp_path)
    store.write_verify_vkey(vk)
    shape = {"n_targets": 1, "n_proofs": [2]}
    assert harness.load_checkpoint(store, 6, shape, "cpu") is None
    harness.write_checkpoint(store, 6, apk, shape)
    path, fp_path = harness.checkpoint_paths(store, 6)
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        ["verify_circuit.vkey", path.name, fp_path.name])
    assert json.loads(fp_path.read_text()) == dict(
        shape, vk=fixtures.vk_fingerprint(vk))
    got = harness.load_checkpoint(store, 6, shape, "cpu")
    _same_pk(got, apk)
    assert got.vk.transcript_repr() == vk.transcript_repr()
    assert got.domain.k == 6


def test_checkpoint_shape_mismatch_rekeygens(tmp_path, k6_key):
    vk, apk = k6_key
    store = FolderStore(tmp_path)
    store.write_verify_vkey(vk)
    two, one = {"n_targets": 1, "n_proofs": [2]}, {"n_targets": 1, "n_proofs": [1]}
    harness.write_checkpoint(store, 6, apk, two)
    assert harness.load_checkpoint(store, 6, one, "cpu") is None
    # a run killed between the npz and its sidecar: the sidecar names the
    # new shape, the npz (the old key) its own, which decides
    _path, fp_path = harness.checkpoint_paths(store, 6)
    fp_path.write_text(json.dumps(one))
    assert harness.load_checkpoint(store, 6, one, "cpu") is None
    fp_path.unlink()
    assert harness.load_checkpoint(store, 6, one, "cpu") is None
    _same_pk(harness.load_checkpoint(store, 6, two, "cpu"), apk)

    # the same counts, but other target vks (sample_setup re-run), or a
    # stored vkey that is not the checkpoint's (verify_setup re-run on
    # other targets): keygen again
    harness.write_checkpoint(store, 6, apk, dict(two, targets=["aaaa"]))
    assert harness.load_checkpoint(store, 6, dict(two, targets=["bbbb"]),
                                   "cpu") is None
    other = pkzg.ParamsKZG.unsafe_setup(6, seed=b"another setup")
    other_vk, _pk = pkeygen.keygen(psimple.SimpleMulCircuit(2, 3), 6, other)
    assert fixtures.vk_fingerprint(other_vk) != fixtures.vk_fingerprint(vk)
    store.write_verify_vkey(other_vk)
    assert harness.load_checkpoint(store, 6, dict(two, targets=["aaaa"]),
                                   "cpu") is None
    store.write_verify_vkey(vk)
    _same_pk(harness.load_checkpoint(store, 6, dict(two, targets=["aaaa"]),
                                     "cpu"), apk)


def test_checkpoint_temp_file_never_loaded(tmp_path, k6_key):
    vk, apk = k6_key
    store = FolderStore(tmp_path)
    store.write_verify_vkey(vk)
    path, _fp = harness.checkpoint_paths(store, 6)
    shape = {"n_targets": 1, "n_proofs": [2]}
    # a write killed before its os.replace leaves only a temp file
    stale = path.with_name(f"{path.name}.tmp999")
    stale.write_bytes(b"torn")
    assert harness.load_checkpoint(store, 6, shape, "cpu") is None

    def killed(f):
        f.write(b"half")
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        harness._replace_into(path, killed)
    assert not path.exists()
    assert harness.load_checkpoint(store, 6, shape, "cpu") is None
    harness.write_checkpoint(store, 6, apk, shape)
    _same_pk(harness.load_checkpoint(store, 6, shape, "cpu"), apk)
    with open(path, "rb") as f:
        assert f.read(2) == b"PK"  # a whole npz (zip) file


# -- the second recursion layer's glue and verify_solidity's outer flow ---------


G1 = (1, 2)  # the G1 generator: a stand-in final pair for the stores


@pytest.fixture(scope="module")
def l1_stores(tmp_path_factory):
    """A JAX and a port store, each holding a K=6 SimpleMul proof made with
    PoseidonWrite (the JAX host prover's bytes in both) under the
    verify_circuit_* names, as a layer-1 outer proof is stored; beside it
    the target params and a final pair, as verify_run leaves them."""
    from halo2_snark_aggregator_tpu.utils.store import FolderStore as JaxStore

    k = SimpleMulCircuit.K
    params = ParamsKZG.unsafe_setup(k)
    c = SimpleMulCircuit(3, 5)
    vk, pk = keygen(c, k, params)
    proof = create_proof(pk, params, [c], [c.instances()], PoseidonWrite(), seed=0)
    pparams = pkzg.ParamsKZG.unsafe_setup(k)
    pvk, _ppk = pkeygen.keygen(psimple.SimpleMulCircuit(3, 5), k, pparams)
    root = tmp_path_factory.mktemp("l1")
    stores = {}
    for name, store, v, p in (("jax", JaxStore(root / "jax"), vk, params),
                              ("port", FolderStore(root / "port"), pvk, pparams)):
        store.write_verify_vkey(v)
        store.write_verify_proof(proof)
        store.write_verify_instance(c.instances())
        store.write_target_params("simple", p)
        store.write_final_pair(G1, G1)
        stores[name] = store
    return dict(k=k, stores=stores, params=params, pparams=pparams, proof=proof,
                instances=c.instances())


@pytest.fixture
def jax_srs(monkeypatch):
    """The JAX harness and CLI load the layer-1 SRS with the JAX
    `setup_cached_accel`, whose first build at K=6 jit-compiles the
    fixed-base MSM for about a minute on a CPU; the value verifier reads only
    its Lagrange and G2 points, which the host `ParamsKZG` of the same tau
    holds."""
    from halo2_snark_aggregator_tpu.prover import srs as jsrs

    monkeypatch.setattr(jsrs, "setup_cached_accel",
                        lambda k, cache_dir=None: ParamsKZG.unsafe_setup(k))


def _verdict(fn):
    try:
        return fn()
    except (RuntimeError, ValueError, AssertionError) as e:
        return type(e).__name__, str(e)


def test_verify_check_l1_poseidon_matches_reference(l1_stores, jax_srs):
    from halo2_snark_aggregator_tpu.sdk import harness as jharness

    k, stores = l1_stores["k"], l1_stores["stores"]
    aparams = accel.AccelParams.from_params(l1_stores["pparams"], device="cpu")
    assert harness.verify_check_l1_poseidon(stores["port"], k, device="cpu",
                                            params=aparams) is True
    assert jharness.verify_check_l1_poseidon(stores["jax"], k) is True

    # the low byte of the last evaluation, before the opening points (one a
    # rotation set, 32 bytes compressed in the Poseidon transcript)
    proof = l1_stores["proof"]
    sets = rotation_sets(query_plan(stores["port"].read_verify_vkey(), 1))
    bad = bytearray(proof)
    bad[len(proof) - 32 * len(sets) - 32] ^= 0x01
    try:
        for store in stores.values():
            store.write_verify_proof(bytes(bad))
        got = _verdict(lambda: harness.verify_check_l1_poseidon(
            stores["port"], k, device="cpu", params=aparams))
        want = _verdict(lambda: jharness.verify_check_l1_poseidon(stores["jax"], k))
    finally:
        for store in stores.values():
            store.write_verify_proof(proof)
    assert got == want == ("RuntimeError",
                           "layer-1 poseidon proof failed native verification")


def test_layer2_target_matches_reference(l1_stores):
    """verify2_run's one target: the same vk digest, instances and proof
    bytes as the JAX verify2_run builds; the layer-2 keygen checkpoint names
    the layer-1 vk's fingerprint."""
    from halo2_snark_aggregator_tpu.circuits import aggregator as jagg
    from halo2_snark_aggregator_tpu_torch.circuits.aggregator import AggregatorCircuit

    jstore = l1_stores["stores"]["jax"]
    want = jagg.VerifierCircuitTarget(
        name="verify_circuit_l1", vk=jstore.read_verify_vkey(),
        params=l1_stores["params"],
        proofs=[jagg.SingleProofWitness(instances=jstore.read_verify_instance(),
                                        transcript=jstore.read_verify_proof())])
    got = harness.layer2_target(l1_stores["stores"]["port"], l1_stores["pparams"])
    assert got.name == want.name
    assert fixtures.vk_fingerprint(got.vk) == fixtures.vk_fingerprint(want.vk)
    assert got.vk.transcript_repr() == want.vk.transcript_repr()
    assert [p.instances for p in got.proofs] == [p.instances for p in want.proofs]
    assert [p.transcript for p in got.proofs] == [p.transcript for p in want.proofs]
    assert harness.aggregator_shape(AggregatorCircuit([got])) == {
        "n_targets": 1, "n_proofs": [1],
        "targets": [fixtures.vk_fingerprint(got.vk)]}


def test_verify2_run_refuses_another_l1_k(l1_stores, tmp_path):
    with pytest.raises(ValueError, match="the layer-1 proof is at k=6, not 7"):
        harness.verify2_run(l1_stores["stores"]["port"], FolderStore(tmp_path),
                            l1_k=7, l2_k=22, device="cpu")


def test_verify_solidity_keccak_outer_refused_as_reference(l1_stores, jax_srs):
    """Over a stored outer proof both CLIs refuse --algo keccak256 with the
    same exit (the outer proof's transcript is SHA-256)."""
    exits = []
    for mod, store in ((jcli, l1_stores["stores"]["jax"]),
                       (pcli, l1_stores["stores"]["port"])):
        with pytest.raises(SystemExit) as e:
            mod.main(["-c", "verify_solidity", "-f", str(store.folder),
                      "--algo", "keccak256", "--agg-k", str(l1_stores["k"]),
                      "--cpu"])
        exits.append(e.value.code)
    assert exits[0] == exits[1] == ("stored outer proofs use the sha256 "
                                    "transcript (harness.verify_run)")


def test_keygen_synthesis_rows_and_reuse(k6_key):
    """synthesize_keygen counts the rows a circuit uses, smallest_k the least
    k that holds them, and keygen_accel given that synthesis makes the same
    key as its own."""
    vk, _apk = k6_key
    c = psimple.SimpleMulCircuit(2, 3)
    asg = accel.synthesize_keygen(c, 6)
    assert asg.n == 64 and 0 <= asg.max_row_touched < asg.usable_rows
    k = harness.smallest_k(asg)
    assert (1 << k) - (asg.n - asg.usable_rows) > asg.max_row_touched
    assert (1 << (k - 1)) - (asg.n - asg.usable_rows) <= asg.max_row_touched
    aparams = accel.AccelParams.from_params(pkzg.ParamsKZG.unsafe_setup(6),
                                            device="cpu")
    got, _pk = accel.keygen_accel(c, 6, aparams, assignment=asg)
    assert fixtures.vk_fingerprint(got) == fixtures.vk_fingerprint(vk)
