"""The port's BatchedVerifier (protocol/batched.py) on the CPU, where every
kernel wrapper runs its plain twin, against the value-context aggregation
oracle — the oracle the reference BatchedVerifier is held to
(tests/test_batched_verifier.py). (w_x, w_g, ok) must be equal."""

import numpy as np
import pytest
import torch

from halo2_snark_aggregator_tpu.arith.value import ValueContext, ValueEccChip
from halo2_snark_aggregator_tpu.circuits.simple import SimpleMulCircuit
from halo2_snark_aggregator_tpu.circuits.zkevm import ZkevmShapeCircuit
from halo2_snark_aggregator_tpu.ff import bn254 as ff
from halo2_snark_aggregator_tpu.protocol import verify as pv
from halo2_snark_aggregator_tpu.protocol.transcript import PoseidonTranscriptRead
from halo2_snark_aggregator_tpu.prover.keygen import keygen
from halo2_snark_aggregator_tpu.prover.kzg import ParamsKZG
from halo2_snark_aggregator_tpu.prover.prove import create_proof
from halo2_snark_aggregator_tpu.transcript.host import PoseidonWrite
from halo2_snark_aggregator_tpu_torch.ops import field as fo
from halo2_snark_aggregator_tpu_torch.ops import msm as ms
from halo2_snark_aggregator_tpu_torch.parallel import msm_shard
from halo2_snark_aggregator_tpu_torch.protocol import batched as pbatched
from halo2_snark_aggregator_tpu_torch.protocol.batched import BatchedVerifier


def _oracle(params, vk, proofs, insts):
    ctx = ValueContext()
    pchip = ValueEccChip()
    nchip = schip = pchip.scalar_chip
    pdata = [
        pv.ProofData(instances=[inst],
                     transcript=PoseidonTranscriptRead(p, ctx, nchip), key=f"p{i}")
        for i, (p, inst) in enumerate(zip(proofs, insts))
    ]
    agg = PoseidonTranscriptRead(b"", ctx, nchip)
    cp = pv.CircuitProof(name="s", vk=vk, params=params, proofs=pdata)
    w_x, w_g, *_rest, ok = pv.verify_aggregation_proofs_in_chip(
        ctx, nchip, schip, pchip, [cp], agg)
    return w_x, w_g, ok


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


def test_simple_mul_matches_oracle(simple):
    params, vk, proofs, insts = simple
    want = _oracle(params, vk, proofs, insts)
    assert want[2]
    bv = BatchedVerifier(vk, params, batch=2, sample_proof=proofs[0],
                         sample_instances=insts[0], msm_window=8, device="cpu")
    assert bv.verify(proofs, insts) == want


def test_rejects_bad_instance(simple):
    params, vk, proofs, insts = simple
    bv = BatchedVerifier(vk, params, batch=2, sample_proof=proofs[0],
                         sample_instances=insts[0], msm_window=4, device="cpu")
    bad = [list(map(list, inst)) for inst in insts]
    bad[1][0][0] = (bad[1][0][0] + 1) % (2**64)
    *_pair, ok = bv.verify(proofs, bad)
    assert not ok


def test_rejects_bad_points(simple):
    """x >= p and x off the curve fail at decompression."""
    params, vk, proofs, insts = simple
    bv = BatchedVerifier(vk, params, batch=2, sample_proof=proofs[0],
                         sample_instances=insts[0], msm_window=4, device="cpu")
    off = next(ref for kind, ref in bv.manifest if kind == "point_x")
    big = bytearray(proofs[1])
    big[off : off + 32] = b"\xff" * 31 + b"\x7f"
    with pytest.raises(ValueError, match="canonical"):
        bv.verify([proofs[0], bytes(big)], insts)
    x = next(x for x in range(2, 100) if ff.sqrt_mod_p((x**3 + 3) % ff.P) is None)
    offc = bytearray(proofs[1])
    offc[off : off + 32] = x.to_bytes(32, "little")
    with pytest.raises(ValueError, match="curve"):
        bv.verify([proofs[0], bytes(offc)], insts)
    with pytest.raises(ValueError):
        bv.verify(proofs[:1], insts[:1])


@pytest.fixture(scope="module")
def zero_output(simple):
    """Lane 0 proves a public output of 0, so its instance column commits to
    the identity."""
    params, vk, _proofs, _insts = simple
    _vk, pk = keygen(SimpleMulCircuit(2, 3), SimpleMulCircuit.K, params)
    proofs, insts = [], []
    for i, (a, b) in enumerate([(0, 5), (2, 3)]):
        c = SimpleMulCircuit(a, b)
        proofs.append(create_proof(pk, params, [c], [c.instances()],
                                   PoseidonWrite(), seed=30 + i))
        insts.append(c.instances())
    assert insts[0] == [[0]]
    return params, vk, proofs, insts


def test_identity_commitment_matches_oracle(zero_output):
    """A public output of 0 commits its instance column to the identity, so
    an MSM entry of the main path is the identity point with a nonzero
    scalar: the verifier must mask that row and still equal the oracle."""
    params, vk, proofs, insts = zero_output
    want = _oracle(params, vk, proofs, insts)
    assert want[2]
    bv = BatchedVerifier(vk, params, batch=2, sample_proof=proofs[1],
                         sample_instances=insts[1], msm_window=8, device="cpu")
    assert bv.verify(proofs, insts) == want


@pytest.fixture(scope="module")
def zkevm():
    """The multi-phase, multi-lookup zkevm-shape circuit (the main path's
    workload) at k=9: four proofs."""
    k, n_groups = 9, 4
    params = ParamsKZG.unsafe_setup(k)
    vk, pk = keygen(ZkevmShapeCircuit(k=k, seed=1, n_groups=n_groups), k, params)
    proofs, insts = [], []
    for i in range(4):
        c = ZkevmShapeCircuit(k=k, seed=4 + i, n_groups=n_groups)
        proofs.append(create_proof(pk, params, [c], [c.instances()],
                                   PoseidonWrite(), seed=i))
        insts.append(c.instances())
    return params, vk, proofs, insts


def _rows_by_source(bv):
    """Table rows (summed over the plans' gather indices) that read the
    instance commitments, and all table rows."""
    B, C = bv.batch, len(bv.n_instances)
    commit0 = B * len(bv._pt_offs)
    n_commit = sum(int(((i >= commit0) & (i < commit0 + B * C)).sum())
                   for i in bv._gather_idx)
    return n_commit, sum(len(i) for i in bv._gather_idx)


def test_zkevm_shape_matches_oracle(zkevm):
    """Batch 3, msm_window 4, and a bad lane; `last_points` set by each
    call."""
    params, vk, proofs, insts = zkevm
    proofs, insts, batch = proofs[:3], insts[:3], 3
    want = _oracle(params, vk, proofs, insts)
    assert want[2]
    bv = BatchedVerifier(vk, params, batch=batch, sample_proof=proofs[0],
                         sample_instances=insts[0], msm_window=4, device="cpu")
    assert bv.verify(proofs, insts) == want
    n_commit, n_rows = _rows_by_source(bv)
    points = {"device_rows": n_rows - n_commit,
              "host_rows": batch * len(bv.n_instances)}
    assert bv.last_points == points

    bv.last_points = {}
    bad = [list(col) for col in insts[1]]
    bad[0][0] = (bad[0][0] + 1) % (1 << 64)
    *_pair, ok = bv.verify(proofs, [insts[0], bad, insts[2]])
    assert not ok
    assert bv.last_points == points


# -- the point path: device tables against host ints -----------------------------


def _host_points(bv, proofs):
    """{(lane, offset): affine int point or None} of every proof point the
    verifier reads, decompressed on the host."""
    out = {}
    for b, proof in enumerate(proofs):
        for off in bv._pt_offs.tolist():
            raw = proof[off : off + 32]
            if raw == bytes(32):
                out[(b, off)] = None
                continue
            x = int.from_bytes(raw, "little") & ((1 << 255) - 1)
            y = ff.sqrt_mod_p((x ** 3 + 3) % ff.P)
            out[(b, off)] = (x, y if (y & 1) == raw[31] >> 7 else ff.P - y)
    return out


def _host_block(bv, proofs, insts, pts, commits):
    """Phase A's input block packed through host ints, value by value."""
    vals = []
    for kind, ref in bv.manifest:
        for b, proof in enumerate(proofs):
            if kind == "scalar":
                v = int.from_bytes(proof[ref : ref + 32], "little")
            elif kind in ("point_x", "point_y"):
                pt = pts[(b, ref)]
                v = 0 if pt is None else pt[kind == "point_y"]
            elif kind == "instance":
                col, i = ref
                v = insts[b][col][i] % ff.R
            else:
                pt = commits[b][ref]
                v = 0 if pt is None else pt[kind == "inst_commit_y"]
            vals.append(v)
    return fo.ints_to_words(vals).reshape(len(bv.manifest), len(proofs), 8)


def _host_tables(bv, pts, commits):
    """Each plan's table by `ms.ints_table` over the entries' host int points,
    entry-major, padded with the identity, this rank's [lo, hi)."""
    tables = []
    for entries, _l in bv.msm_plans:
        flat = []
        for point, _s in entries:
            for b in range(bv.batch):
                if isinstance(point, pbatched.ConstPoint):
                    flat.append(point.point)
                elif point.source[0] == "proof":
                    flat.append(pts[(b, point.source[1])])
                else:
                    flat.append(commits[b][point.source[1]])
        flat += [None] * (bv._padded_n(len(entries)) - len(flat))
        lo, hi = bv._chunk(len(entries))
        tables.append(ms.ints_table(flat[lo:hi], "cpu"))
    return tables


@pytest.mark.parametrize("pool, zero_point, rank", [
    ("simple", False, None),
    ("simple", True, None),
    ("zero_output", False, None),
    ("zkevm", False, None),
    ("zkevm", True, 1),
])
def test_device_point_path_matches_host_ints(pool, zero_point, rank,
                                             request, monkeypatch):
    """Phase A's input block scattered from the device's decompressed points
    equals the host-packed block; each phase-B2 table gathered on the device
    (x, y, identity mask) equals `ms.ints_table` over the same points through
    host ints, padding rows included. Pools: SimpleMul, a lane whose
    instance commitment is the identity, zkevm shape at batch 4; a proof
    point encoded as 32 zero bytes; rank 1 of 3's [lo, hi) of each plan."""
    params, vk, proofs, insts = request.getfixturevalue(pool)
    group = None
    if rank is not None:
        group = object()
        monkeypatch.setattr(pbatched.msm_shard, "my_chunk",
                            lambda n, _g: msm_shard.chunk_bounds(n, rank, 3))
    bv = BatchedVerifier(vk, params, batch=len(proofs), sample_proof=proofs[0],
                         sample_instances=insts[0], device="cpu", group=group)
    if zero_point:  # a point the MSMs read, in the last lane
        off = next(p.source[1] for entries, _l in bv.msm_plans
                   for p, _s in entries
                   if isinstance(p, pbatched.TapePoint) and p.source[0] == "proof")
        last = bytearray(proofs[-1])
        last[off : off + 32] = bytes(32)
        proofs = proofs[:-1] + [bytes(last)]
    pbytes = bv._proof_bytes(proofs)
    pts = bv._decompress_all(pbytes)
    inputs, commits = bv._pack_inputs(pbytes, insts, pts)
    host = _host_points(bv, proofs)
    assert (None in host.values()) == zero_point
    assert np.array_equal(fo.to_numpy(inputs),
                          _host_block(bv, proofs, insts, host, commits))
    got = bv._msm_tables(pts, commits)
    want = _host_tables(bv, host, commits)
    padded = [bv._padded_n(len(e)) > len(e) * bv.batch for e, _l in bv.msm_plans]
    assert rank is not None or any(padded)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for gc, wc in zip(g, w):
            assert gc.dtype == wc.dtype and torch.equal(gc, wc)


def test_last_points(zkevm):
    """At batch 4 on the zkevm shape: `host_rows` is B x the instance
    columns, `device_rows` every other row of the plans' padded tables; both
    set anew by each call's tables."""
    params, vk, proofs, insts = zkevm
    bv = BatchedVerifier(vk, params, batch=4, sample_proof=proofs[0],
                         sample_instances=insts[0], device="cpu")
    assert bv.last_points == {}
    pbytes = bv._proof_bytes(proofs)
    pts = bv._decompress_all(pbytes)
    _inputs, commits = bv._pack_inputs(pbytes, insts, pts)
    n_commit, n_rows = _rows_by_source(bv)
    assert n_rows == sum(bv._padded_n(len(e)) for e, _l in bv.msm_plans)
    assert 0 < n_commit <= n_rows
    want = {"device_rows": n_rows - n_commit, "host_rows": 4 * len(insts[0])}
    for _call in range(2):
        bv.last_points = {"device_rows": -1, "host_rows": -1}
        bv._msm_tables(pts, commits)
        assert bv.last_points == want
