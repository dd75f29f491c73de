"""Entry `verify`: batched verification, batches back to back through one
`BatchedVerifier.verify` loop (a closed loop: the next batch starts when
the last one is done, as an aggregation pipeline takes its next batch).

Set-up: the SRS, the key (the committed commitments), recording the
verifier for the batch, and `warm_calls` warm batches. Window: batches of
the configuration's committed proofs, `batch` distinct proofs a batch
drawn anew from the seed (traffic.lane_draws). Correct: every batch's
verdict, and the (w_x, w_g) pair of a sample of `compare_calls` batches
drawn from the seed, equal the plain reference's (reference/check.py),
which verifies every committed proof itself and folds them over each
batch's lanes.
"""

from __future__ import annotations

import time

from portbench import harness, program, traffic, window
from portbench import trace as tr
from portbench.reference import check as ref


def run(cell, seed: int, seconds: float, traced: bool, t_process: float,
        system=None) -> harness.Outcome:
    cfg, mix = cell.config, cell.mix
    batch = int(mix["batch"])
    proofs = program.fixture_proofs(cfg)
    on_card = system is None  # the fault tests pass a system of their own
    if on_card:
        system = program.Verifier(cfg, proofs, batch)
    for lanes in traffic.take(traffic.lane_draws(seed, "warm", len(proofs),
                                                 batch), int(mix["warm_calls"])):
        system.verify(lanes)
    if on_card:
        program.synchronize()
    setup_s = time.perf_counter() - t_process

    profiled = int(mix["profile_calls"]) if traced else 0
    calls, profiles, spans = [], [], []
    # the profiler starts before the window: its start-up is no call's time
    prof = tr.start() if profiled else None

    def call(lanes):
        t0 = time.time_ns()
        out = system.verify(lanes)
        t1 = time.time_ns()
        lp = system.last_profile
        calls.append(lanes)
        profiles.append(lp)
        if len(calls) <= profiled:
            spans.append(("verify", t0, t1))
            s = t0
            for name, d in lp.items():
                spans.append((name, s, s + int(d * 1e9)))
                s += int(d * 1e9)
            if len(calls) == profiled:
                tr.stop(prof)
        return out

    win = window.closed_loop(
        call, traffic.lane_draws(seed, "window", len(proofs), batch), seconds)
    device = program.card() if on_card else {"platform": "cpu", "count": 0}
    device["memory_peak_bytes"] = program.peak_bytes() if on_card else 0
    summary = None
    if prof is not None:
        if len(calls) < profiled:
            tr.stop(prof)
        n = min(profiled, len(calls))
        lo, hi = spans[0][1], [s for s in spans if s[0] == "verify"][n - 1][2]
        summary = tr.summarize(tr.device_events(prof), spans, lo, hi)
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
    system.close()
    if on_card:
        program.free()

    # -- the plain reference, after the window ---------------------------
    prm = ref.params(cfg["k"], cfg["srs_seed"],
                     max(len(c) for _p, inst in proofs for c in inst))
    results = ref.verify_many(cfg["k"], cfg["n_groups"], cfg["fingerprint"],
                              prm, proofs)
    all_ok = all(r.ok for r in results)
    compared = traffic.sample(seed, win.calls, int(mix["compare_calls"]))
    folds = ref.aggregate_many(results, [calls[i] for i in compared], prm)
    want = {}  # the reference's verdict, where it computed one
    pairs_wrong = 0
    wrong = set()
    for i, (w_x, w_g, want[i]) in zip(compared, folds):
        if tuple(win.outputs[i][:2]) != (w_x, w_g):
            pairs_wrong += 1
            wrong.add(i)
    # every other batch folds valid proofs only when each committed proof is
    # valid, and then its verdict is true
    verdicts_wrong = 0
    for i, got in enumerate(win.outputs):
        w = want.get(i, True if all_ok else None)
        if w is not None and bool(got[2]) != w:
            verdicts_wrong += 1
            wrong.add(i)

    p90, n = window.percentile(win.durations, 90)
    perms = sum(results[p].permutations for p in calls[0])
    return harness.Outcome(
        attempted=win.calls,
        failed=len(wrong),
        end_to_end={
            "proofs_verified_per_s": window.rate(batch * win.calls, win),
            "verify_batch_p90_ms": p90 * 1e3,
            "setup_s": setup_s,
        },
        readings={"entry": "verify", "spans": profiles, "trace": summary,
                  "profiled_calls": min(profiled, len(calls)),
                  "shapes": {"batch": batch, "permutations_per_call": perms}},
        checks={"fixtures_rejected": (sum(not r.ok for r in results), 0),
                "pairs_wrong": (pairs_wrong, 0),
                "verdicts_wrong": (verdicts_wrong, 0)},
        device=device,
        breakdown=tr.breakdown(summary) if summary else None,
        notes={"batches": win.calls, "p90_samples": n,
               "batches_compared": len(compared), "window_s": win.seconds},
    )
