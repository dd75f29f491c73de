"""The zkevm-shape fixture workloads: committed proofs, and the SRS and key
built by the port's accelerated setup and keygen on the card.

Each workload is the reference's bench.py path at one K
(`_cached_zkevm_proofs_inner`): the key is `keygen_accel` over
`ZkevmShapeCircuit(k, seed=1, n_groups)` on `unsafe_setup_accel(k)`, and
proof i is circuit seed 2 + i with blinding seed i. The proofs in
bench_fixtures/ are named by the key's transcript fingerprint:

  * K=16, 8 groups (27 advice columns): f98756fd8c860e04, 4 proofs;
  * K=18, 43 groups (131 phase-0 advice columns and one phase-1 column,
    the width the root bench.py's ZKEVM_GROUPS=43 gives):
    767a119919e3df76, 1 proof.
    The reference made it with `spill=True`, which moves polynomials to the
    host and changes no value, so the bytes match without it.

`setup(k)` runs that path through the kernels (one fixed-base SRS launch,
NTTs, device commits) and checks the fingerprint before any proof is
trusted; with `cached_srs` the SRS comes from `_cache/` (gitignored,
prover/srs.setup_cached_accel).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from pathlib import Path

from . import device as dv
from .circuits.zkevm import ZkevmShapeCircuit
from .prover import accel, srs

REPO = Path(__file__).resolve().parent.parent
FIXTURE_DIR = REPO / "bench_fixtures"


@dataclasses.dataclass(frozen=True)
class Workload:
    k: int
    n_groups: int      # ZkevmShapeCircuit width of the key
    fingerprint: str   # the key's transcript fingerprint
    proofs: int        # committed proofs for that key

    def circuit(self, seed: int) -> ZkevmShapeCircuit:
        """seed 1 is the key's circuit; proof i of the fixtures is seed 2 + i."""
        return ZkevmShapeCircuit(k=self.k, seed=seed, n_groups=self.n_groups)

    def load_proofs(self, nproofs: int | None = None) -> list:
        return load_proofs(self.k, self.fingerprint,
                           self.proofs if nproofs is None else nproofs)


WORKLOADS = {
    16: Workload(16, 8, "f98756fd8c860e04", 4),
    18: Workload(18, 43, "767a119919e3df76", 1),
}


def workload(k: int) -> Workload:
    if k not in WORKLOADS:
        raise ValueError(f"no fixture workload at K={k}; have {sorted(WORKLOADS)}")
    return WORKLOADS[k]


def vk_fingerprint(vk) -> str:
    return hashlib.sha256(str(vk.transcript_repr()).encode()).hexdigest()[:16]


def check_fingerprint(vk, want: str) -> None:
    fp = vk_fingerprint(vk)
    if fp != want:
        raise RuntimeError(f"vk fingerprint {fp} != {want}: the committed "
                           "proofs are not for this key")


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


def setup(k: int = 16, device="cuda", commit_mode: str = "device",
          cached_srs: bool = False):
    """(AccelParams, vk, AccelPk, timings) of workload K=k: the SRS (from
    `_cache/` when `cached_srs`) and the key built through the kernels.
    timings: `setup_s`, `keygen_s` and, on the card, the peak bytes
    allocated in each (`setup_peak_bytes`, `keygen_peak_bytes`). Raises if
    the key is not the fixtures'."""
    wl = workload(k)
    dev = dv.resolve(device)
    timings = {}
    dv.reset_peak(dev)
    t0 = time.perf_counter()
    if cached_srs:
        params = srs.setup_cached_accel(k, device=dev)
    else:
        params = srs.unsafe_setup_accel(k, device=dev)
    params.commit_mode = commit_mode
    dv.synchronize(dev)
    timings["setup_s"] = time.perf_counter() - t0
    timings["setup_peak_bytes"] = dv.peak_bytes(dev)
    dv.reset_peak(dev)
    t0 = time.perf_counter()
    vk, apk = accel.keygen_accel(wl.circuit(1), k, params)
    dv.synchronize(dev)
    timings["keygen_s"] = time.perf_counter() - t0
    timings["keygen_peak_bytes"] = dv.peak_bytes(dev)
    check_fingerprint(vk, wl.fingerprint)
    return params, vk, apk, timings
