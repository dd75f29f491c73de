"""The plain reference against the committed K=16 proofs."""

import functools

import pytest

from portbench import harness, program
from portbench.reference import bn254 as ff
from portbench.reference import check as ref


@functools.lru_cache(maxsize=None)
def k16():
    cfg = harness.find_cell("zkevm16.verify.b8").config
    proofs = program.fixture_proofs(cfg)
    vk = ref.load_key(cfg["k"], cfg["n_groups"], cfg["fingerprint"])
    prm = ref.params(cfg["k"], cfg["srs_seed"], 1)
    return cfg, proofs, vk, prm


def test_key_is_pinned_by_its_fingerprint(tmp_path, monkeypatch):
    cfg, _proofs, vk, _prm = k16()
    assert ref.fingerprint(vk) == cfg["fingerprint"]
    # one commitment moved: the fingerprint no longer matches
    text = (ref.KEYS / f"{cfg['fingerprint']}.json").read_text()
    first = text.split('"')[3]
    (tmp_path / f"{cfg['fingerprint']}.json").write_text(
        text.replace(first, str(int(first) + 1), 1))
    monkeypatch.setattr(ref, "KEYS", tmp_path)
    with pytest.raises(ValueError, match="fingerprint"):
        ref.load_key(cfg["k"], cfg["n_groups"], cfg["fingerprint"])


def test_proof_0_verifies_and_a_flipped_evaluation_does_not():
    _cfg, proofs, vk, prm = k16()
    proof, inst = proofs[0]
    r = ref.verify_proof(vk, prm, proof, inst)
    assert r.ok and r.permutations == 30 and r.w_x and r.w_g
    bad = bytearray(proof)
    bad[-32] ^= 1
    assert not ref.verify_proof(vk, prm, bytes(bad), inst).ok
    assert not ref.verify_proof(vk, prm, proof[:-32], inst).ok
    assert not ref.verify_proof(vk, prm, proof, [[inst[0][0] + 1]]).ok


def test_instances_from_the_circuit_copy():
    cfg, proofs, _vk, _prm = k16()
    assert ref.instances(cfg["k"], cfg["n_groups"], 2) == proofs[0][1]


def test_lagrange_prefix_from_tau():
    _cfg, _proofs, _vk, prm = k16()
    assert ff.g1_is_on_curve(prm.g_lagrange[0]) and ff.g2_is_on_curve(prm.s_g2)


def test_aggregate_folds_lanes_with_powers_of_lambda():
    _cfg, proofs, vk, prm = k16()
    r0 = ref.verify_proof(vk, prm, *proofs[0])
    r1 = ref.verify_proof(vk, prm, *proofs[1])
    res = [r0, r1]
    w_x, w_g, ok = ref.aggregate(res, [0, 1], prm)
    assert ok
    # by hand: lambda from both squeezes, lane 0 weighs lambda, lane 1 one
    from portbench.reference.poseidon_chip import PoseidonChipSponge
    from portbench.reference.value import ValueContext, ValueFieldChip

    ctx = ValueContext()
    sp = PoseidonChipSponge(ValueFieldChip(), ctx)
    sp.update([r0.squeeze, r1.squeeze])
    lam = sp.squeeze(ctx)
    assert w_x == ff.g1_add(ff.g1_mul(r0.w_x, lam), r1.w_x)
    assert w_g == ff.g1_add(ff.g1_mul(r0.w_g, lam), r1.w_g)
    # a lane order is part of the fold
    assert ref.aggregate(res, [1, 0], prm)[0] != w_x
