"""Prove the K=16 zkevm-shape fixtures on one CUDA card.

    python -m halo2_snark_aggregator_tpu_torch.prove [--proofs N]
        [--commit device|host] [--profile]

Builds the SRS (cached under `_cache/` after the first run) and the key
through the accelerated setup and keygen, then proves fixture proof i
for i < N (default 4: `ZkevmShapeCircuit(k=16, seed=2 + i, n_groups=8)`,
blinding seed i) with `create_proof_accel`, and checks each proof's bytes
against bench_fixtures/. Prints one JSON line: seconds per proof, the
stage split (synthesis, ntt, commit, quotient, open, other; host clock, a
synchronize at every boundary), the device commits' largest bucket load,
largest row load (the accumulate's depth) and seconds by phase summed over
the proof, the slowest commit, and every kernel's launches per proof. With
--profile, one more proof runs under torch.profiler and the line gains
the device busy share and the device time by kernel. Fails without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import device as dv
from . import fixtures
from .kernels import build
from .prover import accel
from .transcript.host import PoseidonWrite


def prove_fixture(params, apk, i: int, timer=None) -> bytes:
    """Fixture proof i: circuit seed 2 + i, blinding seed i."""
    c = fixtures.k16_circuit(2 + i)
    return accel.create_proof_accel(apk, params, [c], [c.instances()],
                                    PoseidonWrite(), seed=i, timer=timer)


def timed_proof(params, apk, i: int) -> dict:
    """Prove fixture i with a stage timer and a commit log; returns the
    proof and its numbers."""
    timer = accel.StageTimer(params.device, True)
    params.commit_log = []
    build.reset_launches()
    dv.synchronize(params.device)
    t0 = time.perf_counter()
    proof = prove_fixture(params, apk, i, timer)
    dv.synchronize(params.device)
    seconds = time.perf_counter() - t0
    log, params.commit_log = params.commit_log, None
    dev_commits = [c for c in log if c["mode"] == "device"]
    return {
        "proof": proof,
        "seconds": seconds,
        "stages_s": timer.seconds,
        "launches": dict(build.LAUNCHES),
        "commits": len(log),
        "commit_s_max": max((c["seconds"] for c in log), default=0.0),
        "max_bucket_load": max((c["max_load"] for c in dev_commits), default=0),
        "max_row_load": max((c["max_row_load"] for c in dev_commits), default=0),
        "commit_split_s": {k: sum(c["split_s"][k] for c in dev_commits)
                           for k in (dev_commits[0]["split_s"] if dev_commits
                                     else ())},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--proofs", type=int, default=fixtures.K16_PROOFS)
    ap.add_argument("--commit", default="device", choices=("device", "host"))
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    dev = dv.cuda_device()
    from .bench import card_info

    params, _vk, apk, timings = fixtures.setup_k16(dev, args.commit,
                                                   cached_srs=True)
    want = fixtures.load_proofs(fixtures.K16, fixtures.K16_FINGERPRINT,
                                args.proofs)
    runs = []
    for i in range(args.proofs):
        r = timed_proof(params, apk, i)
        if r.pop("proof") != want[i][0]:
            raise AssertionError(f"proof {i} differs from the fixture")
        runs.append(r)
    out = {
        "card": card_info(),
        "device": torch.cuda.get_device_name(0),
        "commit_mode": args.commit,
        "setup": timings,
        "seconds_per_proof": sum(r["seconds"] for r in runs) / len(runs),
        "proofs": runs,
    }
    if args.profile:
        out["profile"] = dv.profile_device(
            lambda: prove_fixture(params, apk, 0), params.device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
