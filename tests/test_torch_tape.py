"""The port's tape (arith/tape.py): the recording copies against the
reference's, and the executor against a host value replay of the tape —
every slot of every lane, exact."""

import numpy as np
import pytest

from halo2_snark_aggregator_tpu.arith import tape as jtape
from halo2_snark_aggregator_tpu.circuits.simple import SimpleMulCircuit
from halo2_snark_aggregator_tpu.ff import bn254 as ff
from halo2_snark_aggregator_tpu.hashes import poseidon_spec as pspec
from halo2_snark_aggregator_tpu.ops import field_rr
from halo2_snark_aggregator_tpu.protocol import batched as jbatched
from halo2_snark_aggregator_tpu.protocol import verify as pv
from halo2_snark_aggregator_tpu.prover.keygen import keygen
from halo2_snark_aggregator_tpu.prover.kzg import ParamsKZG
from halo2_snark_aggregator_tpu.prover.prove import create_proof
from halo2_snark_aggregator_tpu.transcript.host import PoseidonWrite
from halo2_snark_aggregator_tpu_torch import convert
from halo2_snark_aggregator_tpu_torch.arith import tape as ptape
from halo2_snark_aggregator_tpu_torch.ops import field as fo
from halo2_snark_aggregator_tpu_torch.protocol import batched as pbatched


@pytest.fixture(scope="module")
def simple():
    k = SimpleMulCircuit.K
    params = ParamsKZG.unsafe_setup(k)
    vk, pk = keygen(SimpleMulCircuit(2, 3), k, params)
    proofs, insts = [], []
    for i, (a, b) in enumerate([(2, 3), (5, 7)]):
        c = SimpleMulCircuit(a, b)
        proofs.append(create_proof(pk, params, [c], [c.instances()],
                                   PoseidonWrite(), seed=20 + i))
        insts.append(c.instances())
    return params, vk, proofs, insts


def _record(tape_mod, batched_mod, vk, params, proof, inst_lens):
    """The batched verifier's record step, with either package's classes."""
    tape = tape_mod.Tape()
    schip = tape_mod.TapeFieldChip(tape)
    pchip = batched_mod.TapeEccChip(schip)
    manifest, points = [], []
    for col, nvals in enumerate(inst_lens):
        for i in range(nvals):
            schip.assign_input(None)
            manifest.append(("instance", (col, i)))
        x = schip.assign_input(None)
        y = schip.assign_input(None)
        manifest += [("inst_commit_x", col), ("inst_commit_y", col)]
        points.append(batched_mod.TapePoint(("instance_commit", col), x.idx, y.idx))
    tr = batched_mod.RecordingTranscript(proof, schip, manifest)
    pv.verify_single_proof_no_eval(None, schip, schip, pchip, [points], vk,
                                   params, tr, "")
    tr.squeeze_challenge_scalar(None, schip, schip)
    return tape, manifest


def test_recording_copies_match_reference(simple):
    params, vk, proofs, insts = simple
    lens = [len(c) for c in insts[0]]
    ref, ref_man = _record(jtape, jbatched, vk, params, proofs[0], lens)
    got, got_man = _record(ptape, pbatched, vk, params, proofs[0], lens)
    assert got_man == ref_man
    for attr in ("n_slots", "records", "consts", "input_slots",
                 "poseidon_calls", "inv_calls"):
        assert getattr(got, attr) == getattr(ref, attr), attr
    assert [s[0] for s in got.segments()] == [s[0] for s in ref.segments()]

    ref_pose, ref_plan = jtape._reordered_plan(ref)
    got_pose, got_plan = ptape._reordered_plan(got)
    assert all(np.array_equal(a, b) for a, b in zip(got_pose, ref_pose))
    assert [k for k, _ in got_plan] == [k for k, _ in ref_plan]
    for (kind, g), (_, r) in zip(got_plan, ref_plan):
        if kind == "invb":
            assert all(np.array_equal(a, b) for a, b in zip(g, r))
        else:
            for gt, rt in zip(g[:2], r[:2]):
                assert all(np.array_equal(gt[op], rt[op]) for op in ptape._OPS)
            assert g[2:] == r[2:]


def _replay(tape, inputs):
    """Host value replay of a tape in record order (Python ints mod r)."""
    r = ff.R
    vals = {}
    for slot, v in tape.consts:
        vals[slot] = v % r
    for slot, v in zip(tape.input_slots, inputs):
        vals[slot] = v % r
    for kind, ref in tape.segments():
        if kind == "ops":
            for ri in ref:
                op, a, b, out = tape.records[ri]
                x, y = vals[a], vals[b]
                vals[out] = (x * y if op == ptape.OP_MUL else
                             x + y if op == ptape.OP_ADD else x - y) % r
        elif kind == "inv":
            a, out = tape.inv_calls[ref]
            vals[out] = pow(vals[a], r - 2, r)
        else:
            st, inp, out = tape.poseidon_calls[ref]
            s = [vals[i] for i in st]
            for i, v in enumerate(inp):
                s[1 + i] = (s[1 + i] + vals[v]) % r
            if len(inp) < pspec.RATE:
                s[1 + len(inp)] = (s[1 + len(inp)] + 1) % r
            for slot, v in zip(out, pspec.permute(s)):
                vals[slot] = v
    return vals


def test_executor_matches_host_replay(simple):
    """The verifier tape over 2 lanes, on the packed inputs of real proofs
    (Fq coordinates enter unreduced): every slot of every lane."""
    params, vk, proofs, insts = simple
    bv = pbatched.BatchedVerifier(vk, params, batch=2, sample_proof=proofs[0],
                                  sample_instances=insts[0], device="cpu")
    pts = bv._decompress_all(proofs)
    words, _commits = bv._pack_inputs(proofs, insts, pts)
    slots = bv.run_tape.run(fo.to_tensor(words, "cpu"))
    tape = bv.tape
    for lane in range(2):
        ins = fo.words_to_ints(words[:, lane])
        want = _replay(tape, ins)
        got = fo.from_mont_words(fo.FR, slots[:, lane])
        assert len(want) == tape.n_slots
        assert [got[s] for s in range(tape.n_slots)] == [want[s] for s in range(tape.n_slots)]


def test_executor_runs_the_chain_in_one_call(simple, monkeypatch):
    """`run` hands the whole sponge chain to one `sponge_chain` call (one
    kernel launch on a card): the tape's calls in record order."""
    params, vk, proofs, insts = simple
    bv = pbatched.BatchedVerifier(vk, params, batch=2, sample_proof=proofs[0],
                                  sample_instances=insts[0], device="cpu")
    seen = []
    monkeypatch.setattr(ptape.po, "sponge_chain",
                        lambda slots, chain: seen.append(chain))
    n_in = len(bv.tape.input_slots)
    bv.run_tape.run(fo.to_tensor(np.zeros((n_in, 2, 8), np.uint32), "cpu"))
    assert len(seen) == 1
    calls = bv.tape.poseidon_calls
    assert seen[0].st_idx.tolist() == [list(st) for st, _in, _out in calls]
    assert seen[0].out_idx.tolist() == [list(out) for _st, _in, out in calls]
    assert seen[0].n_in.tolist() == [len(inp) for _st, inp, _out in calls]
    assert seen[0].pad_pos.tolist() == [1 + len(inp) if len(inp) < pspec.RATE
                                        else -1 for _st, inp, _out in calls]


def test_constant_table_matches_reference(simple):
    """The executor's constant words equal the reference compile_tape's
    table (Montgomery bytes, field_rr.FR.to_mont_int) after convert.py."""
    params, vk, proofs, insts = simple
    bv = pbatched.BatchedVerifier(vk, params, batch=2, sample_proof=proofs[0],
                                  sample_instances=insts[0], device="cpu")
    ref = np.stack([field_rr.FR.to_mont_int(v) for _s, v in bv.tape.consts])
    assert np.array_equal(convert.tape_consts_from_rr(ref),
                          fo.to_numpy(bv.run_tape.const_words))
    assert bv.run_tape.const_idx.tolist() == [s for s, _v in bv.tape.consts]


def test_tape_skip_ablation(simple, monkeypatch):
    """H2T_TAPE_SKIP leaves that segment kind's output slots unwritten."""
    params, vk, proofs, insts = simple
    monkeypatch.setenv("H2T_TAPE_SKIP", "poseidon")
    bv = pbatched.BatchedVerifier(vk, params, batch=2, sample_proof=proofs[0],
                                  sample_instances=insts[0], device="cpu")
    n_in = len(bv.tape.input_slots)
    slots = bv.run_tape.run(fo.to_tensor(np.zeros((n_in, 2, 8), np.uint32), "cpu"))
    out_rows = [s for _st, _in, out in bv.tape.poseidon_calls for s in out]
    assert not slots[out_rows].any()


def test_executor_refuses_unschedulable_tape():
    tape = ptape.Tape()
    chip = ptape.TapeFieldChip(tape)
    a = chip.assign_input(None)
    b = chip.mul(None, a, a)  # a computed slot absorbed by the sponge
    tape.record_poseidon([chip.assign_const(None, 0)] * pspec.T, [b])
    with pytest.raises(ValueError):
        ptape.compile_tape(tape, 1, "cpu")
