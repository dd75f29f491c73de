"""The port's main-path benchmark: batched verification of the K=16
zkevm-shape proofs on one CUDA card.

    python -m halo2_snark_aggregator_tpu_torch.bench

Four unique committed proofs are tiled 32x to a batch of 128 (every lane
still runs the whole per-proof work: transcript replay, lambda scaling, its
MSM entries). One warm `verify`, then BENCH_REPS (default 3) timed ones,
each ending in the host pairing check. Prints one JSON line with the metric
`zkevm_shape_proofs_verified_per_sec`; the unit names the card and its
power limit. Fails without a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

from . import device as dv
from . import fixtures
from .protocol.batched import BatchedVerifier

DUP = 32


def card_info() -> str:
    """`name, power.limit` as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def bench_zkevm_batched(dev: torch.device, reps: int) -> dict:
    params, vk, _apk, _timings = fixtures.setup_k16(dev, "device",
                                                    cached_srs=True)
    proofs = fixtures.load_proofs(fixtures.K16, fixtures.K16_FINGERPRINT,
                                  fixtures.K16_PROOFS)
    proofs = proofs * DUP
    proof_bytes = [p for p, _ in proofs]
    insts = [i for _, i in proofs]
    batch = len(proofs)
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
        "unit": (f"proofs/s (batched zkevm-shape K=16, batch {batch}, "
                 f"{DUP}x-tiled proof set, phases A+B on {card_info()}, "
                 f"incl. pairing)"),
        "stages_s": bv.last_profile,
    }


def main() -> int:
    dev = dv.cuda_device()
    reps = int(os.environ.get("BENCH_REPS", "3"))
    print(json.dumps(bench_zkevm_batched(dev, reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
