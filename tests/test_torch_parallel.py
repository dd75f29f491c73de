"""The port's sharding (halo2_snark_aggregator_tpu_torch/parallel/) on the
CPU: worlds of 1, 2 and 4 ranks, each a spawned process, over gloo with a
`file://` rendezvous in a temporary directory, every kernel wrapper running
its plain twin. Each world runs several legs (`parallel/dryrun.run_legs`)
and the tests read their results, exactly, as canonical integers and
words, against the JAX package:

  * the sharded MSM (worlds 1, 2, 4; 41 points with zero scalars and an
    identity point; a rank with an empty chunk, one with only zero scalars,
    one with only the identity) == the JAX `msm_sharded_lite_host` on
    `make_mesh(4)` and `ff.g1_msm`;
  * the two-level MSM on 2 x 2 and 1 x 4 grids == the JAX `msm_hier_lite`
    on `make_host_mesh(2, 2)`;
  * the four-step NTT (k1 = 4, k2 = 6) over 2 and 4 ranks, forward and
    inverse, == `ntt_batch_plain` at k = 10 word for word, the inverse
    giving back the input; its twiddle table == the JAX `_twiddle_table`,
    its reassembly == the JAX `ntt_sharded_to_host`; the JAX `ntt_sharded`
    itself (~52 s on a CPU) only with RUN_SLOW;
  * `BatchedVerifier(group=)` over 2 ranks == the JAX value oracle on
    SimpleMul batch 2, and a bad instance fails on every rank;
  * `verify_check(group=)` over 2 ranks, its 37-point MSM sharded, == the
    JAX value context's pair;
  * the dry run at world 4; a rank that raises makes `spawn` raise within
    its timeout.

Each world's ranks must join within TIMEOUT seconds of their start and
finish within TIMEOUT seconds of the last join (`group.spawn`), and no
rank may import jax or the JAX package.
"""

import os
import random

import numpy as np
import pytest
import torch

from halo2_snark_aggregator_tpu.arith.value import ValueContext, ValueEccChip
from halo2_snark_aggregator_tpu.circuits.simple import SimpleMulCircuit
from halo2_snark_aggregator_tpu.ff import bn254 as ff
from halo2_snark_aggregator_tpu.ops import curve_lite as cvl
from halo2_snark_aggregator_tpu.ops import field as jfo
from halo2_snark_aggregator_tpu.parallel import msm_shard as jms
from halo2_snark_aggregator_tpu.parallel import multihost as jmh
from halo2_snark_aggregator_tpu.parallel import ntt_shard as jntt
from halo2_snark_aggregator_tpu.protocol import verify as jpv
from halo2_snark_aggregator_tpu.protocol.transcript import PoseidonTranscriptRead
from halo2_snark_aggregator_tpu.prover.keygen import keygen
from halo2_snark_aggregator_tpu.prover.kzg import ParamsKZG
from halo2_snark_aggregator_tpu.prover.prove import create_proof
from halo2_snark_aggregator_tpu.transcript.host import PoseidonWrite
from halo2_snark_aggregator_tpu_torch.circuits import simple as psimple
from halo2_snark_aggregator_tpu_torch.ops import field as fo
from halo2_snark_aggregator_tpu_torch.ops import ntt as nt
from halo2_snark_aggregator_tpu_torch.parallel import dryrun as dr
from halo2_snark_aggregator_tpu_torch.parallel import group as pg
from halo2_snark_aggregator_tpu_torch.parallel import msm_shard, ntt_shard
from halo2_snark_aggregator_tpu_torch.prover import keygen as pkeygen
from halo2_snark_aggregator_tpu_torch.prover import kzg as pkzg
from halo2_snark_aggregator_tpu_torch.utils.store import FolderStore

TIMEOUT = 59.0
K1, K2 = 4, 6


def _msm_case():
    """41 points, three zero scalars, point 11 the identity."""
    rng = random.Random(3)
    pts = [ff.g1_mul(ff.G1_GEN, rng.randrange(1, ff.R)) for _ in range(41)]
    scalars = [rng.randrange(ff.R) for _ in range(41)]
    for i in (3, 17, 30):
        scalars[i] = 0
    pts[11] = None
    return pts, scalars


def _oracle(pts, scalars):
    live = [(p, s) for p, s in zip(pts, scalars) if p is not None]
    return ff.g1_msm([p for p, _ in live], [s for _, s in live])


PTS, SCALARS = _msm_case()
# over 4 ranks: chunks [0,1) all zero scalars, [1,2) the identity only,
# [2,3) and [3,5); two nonzero scalars on real points, fewer than the ranks
SMALL = ([PTS[0], None, PTS[2], PTS[3], PTS[4]],
         [0, SCALARS[1], SCALARS[2], 0, SCALARS[4]])
# 3 points over 4 ranks: rank 0's chunk is empty
TINY = (PTS[:3], [SCALARS[0], 0, SCALARS[2]])


def _x_words():
    rng = np.random.default_rng(11)
    words = rng.integers(0, 1 << 32, size=(1 << (K1 + K2), 8), dtype=np.uint64)
    words[:, 7] &= 0x0FFFFFFF  # below r: a canonical Montgomery form
    return words.astype(np.uint32)


X = _x_words()


@pytest.fixture(scope="module")
def ntt_ref():
    x = fo.to_tensor(X, "cpu")
    fwd = nt.ntt_batch_plain(x[None], K1 + K2)[0]
    inv = nt.ntt_batch_plain(fwd[None], K1 + K2, inverse=True)[0]
    return fo.to_numpy(fwd), fo.to_numpy(inv)


def _ntt_legs(ntt_fwd):
    return [("ntt_fwd", dr.ntt_leg, (X, K1, K2, False)),
            ("ntt_inv", dr.ntt_leg, (ntt_fwd, K1, K2, True))]


@pytest.fixture(scope="module")
def simple_mul(tmp_path_factory):
    """The JAX value pair of two SimpleMul proofs (the SDK demo's circuits,
    JAX host prover), the port's vk and params, and a demo folder holding
    them for verify_check."""
    k = SimpleMulCircuit.K
    params = ParamsKZG.unsafe_setup(k)
    vk, pk = keygen(SimpleMulCircuit(2, 3), k, params)
    proofs, insts = [], []
    for i in range(2):
        c = SimpleMulCircuit(3 + i, 4 + i)
        proofs.append(create_proof(pk, params, [c], [c.instances()],
                                   PoseidonWrite(), seed=i))
        insts.append(c.instances())
    ctx, pchip = ValueContext(), ValueEccChip()
    nchip = schip = pchip.scalar_chip
    pdata = [jpv.ProofData(instances=[inst],
                           transcript=PoseidonTranscriptRead(p, ctx, nchip),
                           key=f"p{i}")
             for i, (p, inst) in enumerate(zip(proofs, insts))]
    cp = jpv.CircuitProof(name="s", vk=vk, params=params, proofs=pdata)
    w_x, w_g, *_r, ok = jpv.verify_aggregation_proofs_in_chip(
        ctx, nchip, schip, pchip, [cp], PoseidonTranscriptRead(b"", ctx, nchip))
    assert ok

    pparams = pkzg.ParamsKZG.unsafe_setup(k)
    pvk, _pk = pkeygen.keygen(psimple.SimpleMulCircuit(2, 3), k, pparams)
    folder = tmp_path_factory.mktemp("demo")
    store = FolderStore(folder)
    store.write_target_params("simple", pparams)
    store.write_target_vkey("simple", (pvk, {}))
    for i, (p, inst) in enumerate(zip(proofs, insts)):
        store.write_target_proof("simple", i, p)
        store.write_target_instance("simple", i, inst)
    bad = [[list(col) for col in inst] for inst in insts]
    bad[1][0][0] += 1
    return dict(pair=(w_x, w_g), vk=pvk, params=pparams, proofs=proofs,
                insts=insts, bad=bad, folder=str(folder))


def _spawn(world, legs):
    outs = pg.spawn(dr.run_legs, world, "cpu", "gloo", TIMEOUT, args=(legs,))
    for o in outs:
        assert o.forbidden == []
        assert not any(o.launches.values())  # the CPU runs the plain twins
    return [{name: res for name, (res, _n) in o.result.items()} for o in outs]


@pytest.fixture(scope="module")
def jax_msm():
    """The JAX sharded (lite engine, 4-device mesh) and two-level (2 x 2)
    MSMs of the 41-point case."""
    sharded = jms.msm_sharded_lite_host(PTS, SCALARS, jms.make_mesh(4), c=4)
    pad = -len(PTS) % 4  # msm_hier_lite takes a multiple of the devices
    hier = jmh.msm_hier_lite(
        cvl.from_affine_ints(PTS + [None] * pad),
        jfo.ints_to_limbs([s % ff.R for s in SCALARS] + [0] * pad),
        jmh.make_host_mesh(2, 2), c=4)
    assert sharded == hier == _oracle(PTS, SCALARS)
    return sharded


@pytest.fixture(scope="module")
def world1():
    return _spawn(1, [("msm", dr.msm_leg, (PTS, SCALARS))])


@pytest.fixture(scope="module")
def world2(ntt_ref):
    return _spawn(2, [("msm", dr.msm_leg, (PTS, SCALARS)),
                      *_ntt_legs(ntt_ref[0])])


@pytest.fixture(scope="module")
def world2_check(simple_mul):
    """verify_check(group=) with the hybrid chips' device_min at 16: the
    demo's 37-point MSM is sharded, its 5-point one stays on the host (each
    sharded MSM runs the reduce twin at the chips' window 8, ~6 s on a
    CPU)."""
    return _spawn(2, [("check", dr.check_leg, (
        simple_mul["folder"], [("simple", 6, 2)], 16))])


@pytest.fixture(scope="module", params=["insts", "bad"])
def world2_verify(simple_mul, request):
    """The batched verifier over the good instances, and over a bad one, a
    world each: phase A runs whole on each rank and is by far the slowest
    leg on the CPU (~10 s a verify with the plain twins)."""
    sm = simple_mul
    return request.param, _spawn(2, [("verify", dr.verify_leg, (
        sm["vk"], sm["params"], sm["proofs"], sm[request.param]))])


@pytest.fixture(scope="module")
def world4(ntt_ref):
    return _spawn(4, [
        ("msm", dr.msm_leg, (PTS, SCALARS)),
        ("msm_small", dr.msm_leg, SMALL),
        ("msm_tiny", dr.msm_leg, TINY),
        ("hier_2x2", dr.hier_leg, (PTS, SCALARS, 2)),
        ("hier_1x4", dr.hier_leg, (PTS, SCALARS, 1)),
        *_ntt_legs(ntt_ref[0]),
    ])


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_msm_matches_reference(world, jax_msm, request):
    ranks = request.getfixturevalue(f"world{world}")
    assert len(ranks) == world
    for res in ranks:
        assert res["msm"] == jax_msm


@pytest.mark.parametrize("case", ["msm_small", "msm_tiny"])
def test_sharded_msm_empty_zero_identity_chunks(world4, case):
    pts, scalars = SMALL if case == "msm_small" else TINY
    want = _oracle(pts, scalars)
    assert want is not None
    for res in world4:
        assert res[case] == want


@pytest.mark.parametrize("grid", ["hier_2x2", "hier_1x4"])
def test_two_level_msm_matches_reference(world4, jax_msm, grid):
    for res in world4:
        assert res[grid] == jax_msm


@pytest.mark.parametrize("world", [2, 4])
def test_four_step_ntt_matches_plain(world, ntt_ref, request):
    fwd, inv = ntt_ref
    assert (inv == X).all()  # the round trip gives back the input
    ranks = request.getfixturevalue(f"world{world}")
    for name, want in (("ntt_fwd", fwd), ("ntt_inv", inv)):
        r = np.concatenate([res[name] for res in ranks])
        assert r.shape == (1 << K1, 1 << K2, 8)
        assert (ntt_shard.ntt_sharded_to_host(r).view(np.uint32)
                == want.view(np.uint32)).all()
    # every rank returned only its own rows
    assert all(len(res["ntt_fwd"]) == (1 << K1) // world for res in ranks)


@pytest.mark.parametrize("inverse", [False, True])
def test_twiddle_table_matches_reference(inverse):
    want = jntt._twiddle_table(K1, K2, inverse)
    got = ntt_shard.twiddle_rows(K1, K2, 0, 1 << K2, inverse, "cpu")
    assert tuple(got.shape) == (1 << K2, 1 << K1, 8)
    got_ints = fo.words_to_ints(got.reshape(-1, 8))
    want_ints = [jfo.FR.from_mont_limbs(row) for row in want.reshape(-1, 16)]
    rinv = pow(fo.FR.r_mont, -1, ff.R)
    assert [v * rinv % ff.R for v in got_ints] == want_ints
    # a rank's rows are the table's rows
    part = ntt_shard.twiddle_rows(K1, K2, 16, 32, inverse, "cpu")
    assert torch.equal(part, got[16:32])


def test_reassembly_matches_reference():
    r = np.arange((1 << K1) * (1 << K2) * 16, dtype=np.uint32).reshape(
        1 << K1, 1 << K2, 16)
    assert (ntt_shard.ntt_sharded_to_host(r)
            == jntt.ntt_sharded_to_host(r)).all()


@pytest.mark.skipif("RUN_SLOW" not in os.environ,
                    reason="the JAX ntt_sharded takes ~52 s on a CPU; "
                           "RUN_SLOW=1 enables")
def test_four_step_ntt_matches_jax_ntt_sharded(world4):
    mont = np.stack([jfo.FR.to_mont_int(v) for v in fo.from_mont_words(
        fo.FR, fo.to_tensor(X, "cpu"))])
    want = jntt.ntt_sharded_to_host(jntt.ntt_sharded(mont, K1, K2,
                                                     jms.make_mesh(4)))
    got = ntt_shard.ntt_sharded_to_host(
        np.concatenate([res["ntt_fwd"] for res in world4]))
    want_ints = [jfo.FR.from_mont_limbs(row) for row in want]
    assert fo.from_mont_words(fo.FR, torch.from_numpy(got)) == want_ints


def test_sharded_batched_verifier_matches_oracle(world2_verify, simple_mul):
    insts, ranks = world2_verify
    for res in ranks:
        w_x, w_g, ok, stages = res["verify"]
        if insts == "bad":  # fails on every rank
            assert not ok
        else:
            assert (w_x, w_g) == simple_mul["pair"] and ok
        assert stages[-4:] == ["phase_b2", "gather", "combine", "pairing"]


def test_sharded_hybrid_chips_match_value_context(world2_check, simple_mul):
    for res in world2_check:
        assert res["check"] == simple_mul["pair"]
    stored = FolderStore(simple_mul["folder"]).read_final_pair()
    assert stored == simple_mul["pair"]


def test_chunks_cover_without_padding():
    for n in (0, 3, 41, 1 << 10):
        for world in (1, 2, 3, 4, 8):
            bounds = [msm_shard.chunk_bounds(n, r, world) for r in range(world)]
            assert bounds[0][0] == 0 and bounds[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
            assert max(hi - lo for lo, hi in bounds) <= -(-n // world)


def test_dryrun_world4():
    assert dr.main(["--world", "4", "--device", "cpu", "--timeout",
                    str(TIMEOUT)]) == 0


def test_failing_rank_raises_within_timeout():
    """Rank 1's chunk holds a point that is not one: it raises while rank 0
    waits in the all-gather; spawn stops the world and raises."""
    import time

    bad_points = PTS[:3] + ["not a point"]
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        pg.spawn(dr.run_legs, 2, "cpu", "gloo", TIMEOUT,
                 args=([("msm", dr.msm_leg, (bad_points, SCALARS[:4]))],))
    assert time.perf_counter() - t0 < TIMEOUT


def test_backend_and_device_are_checked():
    with pytest.raises(ValueError):
        pg.rank_device("nccl", "cpu", 0)
    with pytest.raises(ValueError):
        pg.rank_device("mpi", "cpu", 0)
    with pytest.raises(ValueError):
        pg.spawn(dr.run_legs, 0, args=([],))
