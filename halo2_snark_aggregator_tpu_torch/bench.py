"""The port's main-path benchmark: batched verification of the zkevm-shape
proofs on one CUDA card; and, with --multihost, the sharded MSM over ranks.

    python -m halo2_snark_aggregator_tpu_torch.bench [--k 16|18]
    python -m halo2_snark_aggregator_tpu_torch.bench --multihost [--world N]
    torchrun --nproc-per-node N -m halo2_snark_aggregator_tpu_torch.bench --multihost

The committed proofs of workload K=k (fixtures.WORKLOADS; K=16 by default)
are tiled to a batch of 128, the batch the root bench.py's defaults give
(ZKEVM_NPROOFS 4 x ZKEVM_DUP 32): K=16's four proofs 32x, K=18's one proof
128x. Every lane still runs the whole per-proof work: transcript replay,
lambda scaling, its MSM entries. One warm `verify`, then BENCH_REPS
(default 3) timed ones, each ending in the host pairing check. Prints one
JSON line with the metric `zkevm_shape_proofs_verified_per_sec`, the tape's
records and the MSM entries per lane; the unit names the card and its
power limit. Fails without a card.

--multihost is the counterpart of the root bench.py's `bench_multihost`:
the sharded MSM (parallel/msm_shard.py) of the K=16 SRS's 2^16 points
(the root bench's BENCH_MSM_SIZE default) with uniform scalars from a
fixed seed, one warm and BENCH_REPS timed runs between barriers, over the
ranks torchrun starts or, with --world N, that `parallel/group.spawn`
starts. NCCL with one card a rank where there are as many cards as ranks,
else gloo with every rank on cuda:0. Rank 0 prints one JSON line: points/s
(the slowest rank's time), the backend and the cards used. Ranks that
share a card are no scaling measurement. It is wired into no benchmark
cell.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from . import device as dv
from . import fixtures
from .protocol.batched import BatchedVerifier

BATCH = 128


def card_info() -> str:
    """`name, power.limit` as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def tiled_proofs(k: int) -> tuple[list, list]:
    """(proof bytes, instances) of workload K=k's committed proofs, tiled
    to BATCH lanes."""
    proofs = fixtures.workload(k).load_proofs()
    proofs = proofs * (BATCH // len(proofs))
    return [p for p, _ in proofs], [i for _, i in proofs]


def bench_zkevm_batched(dev: torch.device, reps: int, k: int = 16) -> dict:
    params, vk, _apk, _timings = fixtures.setup(k, dev, "device",
                                                cached_srs=True)
    proof_bytes, insts = tiled_proofs(k)
    batch = len(proof_bytes)
    dup = batch // fixtures.workload(k).proofs
    bv = BatchedVerifier(vk, params, batch=batch, sample_proof=proof_bytes[0],
                         sample_instances=insts[0], device=dev)
    *_pair, ok = bv.verify(proof_bytes, insts)  # warm
    if not ok:
        raise RuntimeError("warm verify failed its pairing check")
    t0 = time.perf_counter()
    for _ in range(reps):
        *_pair, ok = bv.verify(proof_bytes, insts)
        if not ok:
            raise RuntimeError("timed verify failed its pairing check")
    dt = (time.perf_counter() - t0) / reps
    return {
        "metric": "zkevm_shape_proofs_verified_per_sec",
        "value": batch / dt,
        "unit": (f"proofs/s (batched zkevm-shape K={k}, batch {batch}, "
                 f"{dup}x-tiled proof set, phases A+B on {card_info()}, "
                 f"incl. pairing)"),
        "tape_records": len(bv.tape.records),
        "msm_entries_per_lane": sum(len(e) for e, _ in bv.msm_plans),
        "stages_s": bv.last_profile,
    }


MULTIHOST_K = 16  # 2^16 points, the root bench's BENCH_MSM_SIZE default
MULTIHOST_SEED = 20261017


def multihost_rank(info, reps: int) -> dict:
    """One rank of `--multihost`: its chunk of the SRS and the scalars, the
    sharded MSM, its seconds a run; the point checked against the
    unsharded `msm_totals` + combine on rank 0."""
    import torch.distributed as dist

    from .ops import field as fo
    from .ops import msm as msm_ops
    from .parallel import msm_shard
    from .prover import srs

    params = srs.setup_cached_accel(MULTIHOST_K, device=info.device)
    n = params.n
    gen = torch.Generator().manual_seed(MULTIHOST_SEED)
    w = torch.randint(0, 1 << 32, (n, 8), dtype=torch.int64, generator=gen)
    w[:, 7] %= int(fo.FR.p_words[7])
    scal = fo.to_tensor(w.numpy().astype("uint32"), info.device)
    lo, hi = msm_shard.my_chunk(n)
    table = msm_ops.affine_table(params.g_dev[lo:hi].unbind(1))

    def run():
        return msm_shard.msm_sharded(table, scal[lo:hi], 8)

    pt = run()  # warm
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    dist.barrier()
    dt = (time.perf_counter() - t0) / reps
    if info.rank == 0:
        totals, weights = msm_ops.msm_totals(params.table(), scal, 8)
        if msm_ops.combine_rows_host(totals.unbind(1), weights, 8) != pt:
            raise RuntimeError("the sharded MSM differs from the unsharded")
    return {"n": n, "seconds": dt, "device": str(info.device)}


def multihost_report(outs: list, backend: str) -> dict:
    n = outs[0]["n"]
    dt = max(o["seconds"] for o in outs)
    cards = sorted({o["device"] for o in outs})
    share = " sharing one card" if len(cards) < len(outs) else ""
    return {
        "metric": "bn254_msm_points_per_sec_multihost",
        "value": n / dt,
        "unit": (f"points/s (2^{n.bit_length() - 1} MSM, c=8, {len(outs)} "
                 f"ranks{share}, {backend}, on {card_info()})"),
        "backend": backend, "ranks": len(outs), "cards": len(cards),
        "seconds": dt}


def backend_for(world: int) -> str:
    """NCCL when every rank has a card of its own, else gloo on one card."""
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def bench_multihost(world: int | None, reps: int) -> dict | None:
    """The sharded MSM over torchrun's ranks (world None) or `world` spawned
    ranks; the report on rank 0 (None on the others)."""
    import torch.distributed as dist

    from .parallel import group as pg
    from .prover import srs

    dv.cuda_device()
    if world is None:
        world = int(os.environ["WORLD_SIZE"])
        backend = backend_for(world)
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        info = pg.init_group(backend, pg.rank_device(backend, "cuda", local))
        try:
            outs = [None] * world
            dist.all_gather_object(outs, multihost_rank(info, reps))
        finally:
            dist.destroy_process_group()
        return multihost_report(outs, backend) if info.rank == 0 else None
    backend = backend_for(world)
    srs.setup_cached_accel(MULTIHOST_K, device="cuda")  # the ranks load it
    outs = pg.spawn(multihost_rank, world, "cuda", backend, 600.0,
                    args=(reps,))
    return multihost_report([o.result for o in outs], backend)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=16, choices=sorted(fixtures.WORKLOADS))
    ap.add_argument("--multihost", action="store_true",
                    help="the sharded MSM over ranks (torchrun's, or --world)")
    ap.add_argument("--world", type=int, default=None,
                    help="with --multihost and no torchrun: ranks to spawn")
    args = ap.parse_args()
    reps = int(os.environ.get("BENCH_REPS", "3"))
    if args.multihost:
        report = bench_multihost(args.world, reps)
        if report is not None:
            print(json.dumps(report))
        return 0
    dev = dv.cuda_device()
    print(json.dumps(bench_zkevm_batched(dev, reps, args.k)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
