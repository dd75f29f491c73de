"""Prove the zkevm-shape fixtures on one CUDA card.

    python -m halo2_snark_aggregator_tpu_torch.prove [--k 16|18] [--proofs N]
        [--commit device|host] [--profile]

Builds the SRS (cached under `_cache/` after the first run) and the key of
workload K=k (fixtures.WORKLOADS: K=16 by default, 8 groups; K=18, 43
groups, 131 advice columns) through the accelerated setup and keygen, then
proves fixture proof i for i < N (default: every committed proof of that
key, 4 at K=16 and 1 at K=18; circuit seed 2 + i, blinding seed i) with
`create_proof_accel`, and checks each proof's bytes against bench_fixtures/.
Prints one JSON line: the setup's and keygen's seconds and peak device
bytes, seconds per proof, the stage split (synthesis, ntt, commit,
quotient, open, other; host clock, a synchronize at every boundary) with
each stage's peak device bytes, the device commits' largest bucket load,
largest row load (the accumulate's depth) and seconds by phase summed over
the proof, the slowest commit, every kernel's launches per proof, and the
working set (`working_set`: the peak, and the k = 22 aggregator's
estimate from it, against the 72 GB spill limit). With
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
from .prover.quotient_program import compile_quotient
from .transcript.host import PoseidonWrite


# The SDK's aggregator proves at k = 22 (the reference's --agg-k default);
# its quotient reads 44 distinct columns (tests/test_torch_wide_prover.py
# holds the count against the reference's AggregatorCircuit). The
# reference's spill mode (host-resident polynomials) is ported only if a
# working set passes 90 % of the card's 80 GB.
AGG_K = 22
AGG_QUOTIENT_COLUMNS = 44
SPILL_LIMIT_BYTES = 72e9


def working_set(vk, peak: int) -> dict:
    """The spill decision's numbers: the measured peak of a key's setup,
    keygen and proof, its bytes per quotient column and row, and the k = 22
    aggregator's working set estimated as that times the aggregator's
    quotient columns and rows."""
    cs = vk.cs
    columns = len(compile_quotient(cs, 1, [0] * cs.num_challenges, 0, 0, 0,
                                   0)[1])
    per = peak / (columns << vk.k)
    est = per * (AGG_QUOTIENT_COLUMNS << AGG_K)
    return {"peak_bytes": peak, "quotient_columns": columns,
            "bytes_per_column_row": per,
            "agg_k22_estimate_bytes": est, "limit_bytes": SPILL_LIMIT_BYTES,
            "spill_needed": max(peak, est) > SPILL_LIMIT_BYTES}


def prove_fixture(params, apk, i: int, timer=None) -> bytes:
    """Fixture proof i of the key's workload: circuit seed 2 + i, blinding
    seed i."""
    c = fixtures.workload(params.k).circuit(2 + i)
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
        "stages_peak_bytes": timer.peak_bytes,
        "peak_bytes": max(timer.peak_bytes.values(), default=None),
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
    ap.add_argument("--k", type=int, default=16, choices=sorted(fixtures.WORKLOADS))
    ap.add_argument("--proofs", type=int, default=None)
    ap.add_argument("--commit", default="device", choices=("device", "host"))
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    dev = dv.cuda_device()
    from .bench import card_info

    wl = fixtures.workload(args.k)
    nproofs = wl.proofs if args.proofs is None else args.proofs
    params, vk, apk, timings = fixtures.setup(args.k, dev, args.commit,
                                              cached_srs=True)
    want = wl.load_proofs(nproofs)
    runs = []
    for i in range(nproofs):
        r = timed_proof(params, apk, i)
        if r.pop("proof") != want[i][0]:
            raise AssertionError(f"K={args.k} proof {i} differs from the fixture")
        runs.append(r)
    out = {
        "card": card_info(),
        "device": torch.cuda.get_device_name(0),
        "k": args.k,
        "fingerprint": wl.fingerprint,
        "commit_mode": args.commit,
        "setup": timings,
        "seconds_per_proof": sum(r["seconds"] for r in runs) / len(runs),
        "proofs": runs,
        "working_set": working_set(vk, max(
            timings["setup_peak_bytes"], timings["keygen_peak_bytes"],
            *(r["peak_bytes"] for r in runs))),
    }
    if args.profile:
        out["profile"] = dv.profile_device(
            lambda: prove_fixture(params, apk, 0), params.device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
