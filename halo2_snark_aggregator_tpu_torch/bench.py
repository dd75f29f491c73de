"""The port's main-path benchmark: batched verification of the zkevm-shape
proofs on one CUDA card.

    python -m halo2_snark_aggregator_tpu_torch.bench [--k 16|18]

The committed proofs of workload K=k (fixtures.WORKLOADS; K=16 by default)
are tiled to a batch of 128, the batch the root bench.py's defaults give
(ZKEVM_NPROOFS 4 x ZKEVM_DUP 32): K=16's four proofs 32x, K=18's one proof
128x. Every lane still runs the whole per-proof work: transcript replay,
lambda scaling, its MSM entries. One warm `verify`, then BENCH_REPS
(default 3) timed ones, each ending in the host pairing check. Prints one
JSON line with the metric `zkevm_shape_proofs_verified_per_sec`, the tape's
records and the MSM entries per lane; the unit names the card and its
power limit. Fails without a card.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=16, choices=sorted(fixtures.WORKLOADS))
    args = ap.parse_args()
    dev = dv.cuda_device()
    reps = int(os.environ.get("BENCH_REPS", "3"))
    print(json.dumps(bench_zkevm_batched(dev, reps, args.k)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
