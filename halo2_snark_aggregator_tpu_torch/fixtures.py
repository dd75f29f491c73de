"""The K=16 zkevm-shape workload: committed proofs, and the SRS and key
built by the port's accelerated setup and keygen on the card.

The four proofs in bench_fixtures/ were made for the verifying key with
transcript fingerprint f98756fd8c860e04: `unsafe_setup_accel(16)` and
`keygen_accel` over `ZkevmShapeCircuit(k=16, seed=1, n_groups=8)`, the
reference's bench.py path. `setup_k16` runs that path through the kernels
(SRS add tree, NTTs, device commits) and checks the fingerprint before any
proof is trusted; with `cached_srs` the SRS comes from `_cache/`
(gitignored, prover/srs.setup_cached_accel).
"""

from __future__ import annotations

import hashlib
import json
import time
from pathlib import Path

from . import device as dv
from .circuits.zkevm import ZkevmShapeCircuit
from .prover import accel, srs

REPO = Path(__file__).resolve().parent.parent
FIXTURE_DIR = REPO / "bench_fixtures"
K16 = 16
K16_FINGERPRINT = "f98756fd8c860e04"
K16_GROUPS = 8    # ZkevmShapeCircuit n_groups of the fixtures' key
K16_PROOFS = 4    # committed proofs for that key


def vk_fingerprint(vk) -> str:
    return hashlib.sha256(str(vk.transcript_repr()).encode()).hexdigest()[:16]


def check_fingerprint(vk) -> None:
    fp = vk_fingerprint(vk)
    if fp != K16_FINGERPRINT:
        raise RuntimeError(f"vk fingerprint {fp} != {K16_FINGERPRINT}: the "
                           "committed proofs are not for this key")


def k16_circuit(seed: int) -> ZkevmShapeCircuit:
    """seed 1 is the key's circuit; proof i of the fixtures is seed 2 + i."""
    return ZkevmShapeCircuit(k=K16, seed=seed, n_groups=K16_GROUPS)


def load_proofs(k: int, fingerprint: str, nproofs: int) -> list:
    """[(proof bytes, instances)] from bench_fixtures/."""
    out = []
    for i in range(nproofs):
        path = FIXTURE_DIR / f"zkevm_proof_k{k}_{fingerprint}_{i}.json"
        with open(path) as f:
            d = json.load(f)
        out.append((bytes.fromhex(d["proof"]),
                    [[int(v) for v in col] for col in d["instances"]]))
    return out


def setup_k16(device="cuda", commit_mode: str = "device",
              cached_srs: bool = False):
    """(AccelParams, vk, AccelPk, timings): the SRS (from `_cache/` when
    `cached_srs`) and the key built through the kernels. Raises if the key
    is not the fixtures'."""
    dev = dv.resolve(device)
    timings = {}
    t0 = time.perf_counter()
    if cached_srs:
        params = srs.setup_cached_accel(K16, device=dev)
    else:
        params = srs.unsafe_setup_accel(K16, device=dev)
    params.commit_mode = commit_mode
    dv.synchronize(dev)
    timings["setup_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vk, apk = accel.keygen_accel(k16_circuit(1), K16, params)
    dv.synchronize(dev)
    timings["keygen_s"] = time.perf_counter() - t0
    check_fingerprint(vk)
    return params, vk, apk, timings

