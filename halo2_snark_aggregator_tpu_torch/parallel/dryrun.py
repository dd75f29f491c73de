"""Multi-rank dry run of the sharded paths, every leg checked against the
host oracle.

    python -m halo2_snark_aggregator_tpu_torch.parallel.dryrun --world N \\
        --device cpu|cuda [--backend gloo|nccl] [--timeout SECONDS]

The counterpart of the reference's `__graft_entry__.dryrun_multichip(n)`.
Worlds of N ranks (`group.spawn`; gloo by default: ranks on the CPU or
sharing cuda:0; nccl: rank r on cuda:r) run, in one process a rank (the
verifier in a world of its own):

  * the sharded MSM of 16 N points (`msm_shard.msm_sharded_ints`) ==
    `ff.g1_msm`;
  * 2 N Poseidon permutations sharded by lanes, each rank's lanes through
    the sponge-chain kernel (`ops/poseidon.sponge_chain`) ==
    `hashes/poseidon_spec.permute_py`;
  * the two-level MSM on a 2-host grid (N even) == the sharded MSM;
  * the batched verifier with phase B2 sharded (SimpleMul, k=6, batch 2)
    == the value context's (w_x, w_g), pairing passed.

The reference makes its verifier leg opt-in for its XLA compile time;
here it always runs. Every MSM uses window 4. Prints one `OK` line with
the backend, the device and the launches a kernel, summed over the ranks;
exits 1 on a mismatch, or when a rank imported jax or the JAX package.
`run_legs` and the legs are the rank functions the tests and chip_smoke.py
spawn as well.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..ff import bn254 as ff
from ..hashes import poseidon_spec as pspec
from ..kernels import build
from ..ops import field as fo
from ..ops import poseidon as po
from . import group as pg
from . import msm_shard, multihost, ntt_shard

WINDOW = 4


def run_legs(info: pg.RankInfo, legs: list) -> dict:
    """Run each (name, fn, args) of `legs` as fn(info, *args) in order:
    {name: (result, this leg's launch counts)}; the rank's counts keep the
    sum of all legs."""
    out = {}
    for name, fn, args in legs:
        before = dict(build.LAUNCHES)
        res = fn(info, *args)
        out[name] = (res, {k: n - before[k] for k, n in build.LAUNCHES.items()})
    return out


# -- legs (rank functions) ------------------------------------------------------


def msm_leg(info, points, scalars):
    return msm_shard.msm_sharded_ints(points, scalars, WINDOW, info.device,
                                      dist.group.WORLD)


def hier_leg(info, points, scalars, n_hosts: int):
    host_group, chip_group = pg.host_groups(n_hosts, info.world // n_hosts)
    return multihost.msm_hier_ints(points, scalars, host_group, chip_group,
                                   WINDOW, info.device)


def poseidon_leg(info, states):
    """This rank's lanes of `states` (lists of 9 ints) permuted by one
    sponge-chain launch; every rank returns all lanes, gathered."""
    lo, hi = msm_shard.chunk_bounds(len(states), info.rank, info.world)
    mine = states[lo:hi]
    flat = fo.mont_words(fo.FR, [v for st in mine for v in st], info.device)
    slots = flat.reshape(len(mine), po.T, fo.WORDS).transpose(0, 1).contiguous()
    if mine:
        ident = np.arange(po.T)
        chain = po.chain_table([ident], [np.zeros(po.RATE, int)], [0], [-1],
                               [ident], info.device)
        po.sponge_chain(slots, chain)
    lanes = pg.all_gather(slots.transpose(0, 1).contiguous(), dist.group.WORLD)
    vals = fo.from_mont_words(fo.FR, torch.cat(lanes).reshape(-1, fo.WORDS))
    return [vals[i:i + po.T] for i in range(0, len(vals), po.T)]


def verify_leg(info, vk, params, proofs, insts):
    """(w_x, w_g, ok) of the sharded batched verifier and the stages of its
    `last_profile`."""
    from ..protocol.batched import BatchedVerifier

    bv = BatchedVerifier(vk, params, batch=len(proofs), sample_proof=proofs[0],
                         sample_instances=insts[0], msm_window=WINDOW,
                         device=info.device, group=dist.group.WORLD)
    w_x, w_g, ok = bv.verify(proofs, insts)
    return w_x, w_g, ok, list(bv.last_profile)


def ntt_leg(info, x, k1: int, k2: int, inverse: bool):
    """This rank's rows k1 of the four-step transform of x ((n, 8) words),
    as a host uint32 array."""
    xt = fo.to_tensor(np.asarray(x, np.uint32), info.device)
    b = ntt_shard.shard_rows(xt, k1, k2, info.rank, info.world)
    return fo.to_numpy(ntt_shard.ntt_sharded(b, k1, k2, dist.group.WORLD,
                                             inverse))


def check_leg(info, folder: str, targets, device_min: int):
    """`sdk/harness.verify_check(group=)` over the stored proofs of a
    folder's targets, (name, k, number of proofs) each, every MSM of at
    least `device_min` points sharded (H2T_MSM_DEVICE_MIN, in this rank's
    process): (w_x, w_g)."""
    from ..sdk import harness
    from ..utils.store import FolderStore

    os.environ["H2T_MSM_DEVICE_MIN"] = str(device_min)
    specs = [harness.TargetCircuitSpec(name, k, n, 0, None, None)
             for name, k, n in targets]
    w_x, w_g, _plain = harness.verify_check(specs, FolderStore(folder),
                                            info.device, dist.group.WORLD)
    return w_x, w_g


# -- the dry run ------------------------------------------------------------------


def msm_inputs(n: int, seed: int = 7):
    """The reference dry run's MSM: n consecutive points from 12345 G and
    48-bit scalars from `seed`."""
    rng = np.random.default_rng(seed)
    pts, p = [], ff.g1_mul(ff.G1_GEN, 12345)
    for _ in range(n):
        pts.append(p)
        p = ff.g1_add(p, ff.G1_GEN)
    return pts, [int(rng.integers(1, 1 << 48)) for _ in range(n)]


def simple_mul_batch():
    """(vk, params, proofs, instances, value pair) of two SimpleMul proofs at k=6 from the port's host prover (seeds 30, 31)."""
    from ..arith.value import ValueContext, ValueEccChip
    from ..circuits.simple import SimpleMulCircuit
    from ..protocol import verify as pv
    from ..protocol.transcript import PoseidonTranscriptRead
    from ..prover.keygen import keygen
    from ..prover.kzg import ParamsKZG
    from ..prover.prove import create_proof
    from ..transcript.host import PoseidonWrite

    k = SimpleMulCircuit.K
    params = ParamsKZG.unsafe_setup(k)
    vk, pk = keygen(SimpleMulCircuit(2, 3), k, params)
    proofs, insts = [], []
    for i, (a, b) in enumerate([(2, 3), (5, 7)]):
        circuit = SimpleMulCircuit(a, b)
        proofs.append(create_proof(pk, params, [circuit], [circuit.instances()],
                                   PoseidonWrite(), seed=30 + i))
        insts.append(circuit.instances())
    ctx, pchip = ValueContext(), ValueEccChip()
    nchip = schip = pchip.scalar_chip
    pdata = [pv.ProofData(instances=[inst],
                          transcript=PoseidonTranscriptRead(p, ctx, nchip),
                          key=f"p{i}")
             for i, (p, inst) in enumerate(zip(proofs, insts))]
    cp = pv.CircuitProof(name="s", vk=vk, params=params, proofs=pdata)
    w_x, w_g, *_rest, ok = pv.verify_aggregation_proofs_in_chip(
        ctx, nchip, schip, pchip, [cp], PoseidonTranscriptRead(b"", ctx, nchip))
    if not ok:
        raise RuntimeError("the value oracle rejected the SimpleMul proofs")
    return vk, params, proofs, insts, (w_x, w_g)


def dryrun(world: int, device: str = "cpu", backend: str = "gloo",
           timeout: float = 120.0) -> str:
    """Run the dry run; returns its OK line, raises AssertionError on a
    mismatch."""
    t0 = time.perf_counter()
    pts, scalars = msm_inputs(16 * world)
    want_msm = ff.g1_msm(pts, scalars)
    batch = 2 * world
    states = [[(i * batch + j + 1) % ff.R for j in range(po.T)]
              for i in range(batch)]
    vk, params, proofs, insts, want_pair = simple_mul_batch()
    legs = [("msm", msm_leg, (pts, scalars)),
            ("poseidon", poseidon_leg, (states,))]
    hier = world % 2 == 0
    if hier:
        legs.append(("hier", hier_leg, (pts, scalars, 2)))
    # the verifier's world of its own: its phase A, whole on every rank, is
    # the dry run's heaviest leg on a CPU, and each world has its own bound
    outs = [pg.spawn(run_legs, world, device, backend, timeout, args=(part,))
            for part in (legs, [("verify", verify_leg,
                                 (vk, params, proofs, insts))])]

    launches = dict.fromkeys(build.KERNELS, 0)
    for r, ranks in enumerate(zip(*outs)):
        res = {}
        for o in ranks:
            if o.forbidden:
                raise AssertionError(f"rank {r} imported {o.forbidden[:5]}")
            res.update({k: v for k, (v, _c) in o.result.items()})
            for kname, n in o.launches.items():
                launches[kname] += n
        if res["msm"] != want_msm:
            raise AssertionError(f"rank {r}: sharded MSM mismatch")
        if res["poseidon"] != [pspec.permute_py(list(s)) for s in states]:
            raise AssertionError(f"rank {r}: sharded Poseidon mismatch")
        w_x, w_g, ok, stages = res["verify"]
        if (w_x, w_g) != want_pair or not ok or "gather" not in stages:
            raise AssertionError(f"rank {r}: sharded batched verifier: pair "
                                 f"{(w_x, w_g) == want_pair}, ok {ok}")
        if hier and res["hier"] != want_msm:
            raise AssertionError(f"rank {r}: two-level MSM mismatch")
    return (f"dryrun(world={world}, backend={backend}, device={device}): "
            f"sharded MSM of {len(pts)} points + batch-{batch} Poseidon "
            f"permutations"
            + (f" + two-level (2 x {world // 2}) MSM" if hier else "")
            + " + sharded batched verifier (SimpleMul k=6, batch 2, pair == "
            f"value oracle) OK, host-oracle-checked; "
            f"launches {({k: v for k, v in launches.items() if v})}; "
            f"{time.perf_counter() - t0:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--device", choices=("cpu", "cuda"), required=True)
    ap.add_argument("--backend", choices=pg.BACKENDS, default="gloo")
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args(argv)
    try:
        line = dryrun(args.world, args.device, args.backend, args.timeout)
    except AssertionError as e:
        print(f"dryrun FAILED: {e}", file=sys.stderr)
        return 1
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
