"""Entry `prove`: proofs back to back through `create_proof_accel` (a closed
loop: the next proof starts when the last one is done).

Set-up: the SRS, keygen on the card (the proving key lives there), and
`warm_calls` warm proofs. Window: each call proves the configuration's
circuit for a witness seed and a blinding seed drawn from the run's seed
(traffic.circuit_draws); the window holds whole proofs only. Correct: the
plain reference (reference/check.py) verifies every proof of the window
against the instance its own copy of the circuit derives from the
witness seed; each must pass, with every byte read.

With --trace 1 the port's `StageTimer` splits each proof into its spans
(a synchronize at each boundary), and the first `profile_calls` proofs run
under the profiler; their commitments' scalars are kept, and once the
window has closed the yardstick counts the accumulate's mixed adds from
them (roofline.nonzero_digits).
"""

from __future__ import annotations

import time

from portbench import harness, program, roofline, traffic, window
from portbench import trace as tr
from portbench.reference import check as ref


def run(cell, seed: int, seconds: float, traced: bool, t_process: float,
        system=None) -> harness.Outcome:
    cfg, mix = cell.config, cell.mix
    on_card = system is None  # the fault tests pass a system of their own
    if on_card:
        system = program.Prover(cfg)
    for seeds in traffic.take(traffic.circuit_draws(seed, "warm"),
                              int(mix["warm_calls"])):
        system.prove(seeds)
    setup_s = time.perf_counter() - t_process

    profiled = int(mix["profile_calls"]) if traced else 0
    calls, stages, kept, spans = [], [], [], []
    # the profiler starts before the window: its start-up is no call's time
    prof = tr.start() if profiled else None

    def call(seeds):
        if traced:
            system.timer = program.span_timer(True)
        if len(calls) < profiled:
            system.scalars = []
        t0 = time.time_ns()
        proof = system.prove(seeds)
        t1 = time.time_ns()
        calls.append(seeds)
        if traced:
            stages.append(dict(system.timer.seconds))
        if len(calls) <= profiled:
            kept.append(system.scalars)
            system.scalars = None
            spans.append(("prove", t0, t1))
            spans.extend(system.timer.intervals)
            if len(calls) == profiled:
                tr.stop(prof)
        return proof

    win = window.closed_loop(call, traffic.circuit_draws(seed, "window"),
                             seconds)
    device = program.card() if on_card else {"platform": "cpu", "count": 0}
    device["memory_peak_bytes"] = program.peak_bytes() if on_card else 0
    summary = None
    if prof is not None:
        if len(calls) < profiled:
            tr.stop(prof)
        n = min(profiled, len(calls))
        outer = [s for s in spans if s[0] == "prove"]
        summary = tr.summarize(tr.device_events(prof), spans, outer[0][1],
                               outer[n - 1][2])
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
    counters = [{"accumulate_adds": sum(roofline.nonzero_digits(t.cpu().numpy())
                                        for t in ts)}
                for ts in kept if ts is not None]
    kept.clear()
    system.close()
    if on_card:
        program.free()

    # -- the plain reference, after the window ---------------------------
    vk = ref.load_key(cfg["k"], cfg["n_groups"], cfg["fingerprint"])
    results = []
    prm = None
    for (witness_seed, _b), proof in zip(calls, win.outputs):
        inst = ref.instances(cfg["k"], cfg["n_groups"], witness_seed)
        if prm is None:
            prm = ref.params(cfg["k"], cfg["srs_seed"],
                             max(len(c) for c in inst))
        results.append(ref.verify_proof(vk, prm, proof, inst))
    rejected = [i for i, r in enumerate(results) if not r.ok]
    return harness.Outcome(
        attempted=win.calls,
        failed=len(rejected),
        end_to_end={"prove_s_per_proof": window.per_call(win),
                    "setup_s": setup_s},
        readings={"entry": "prove", "spans": stages, "counters": counters,
                  "trace": summary, "profiled_calls": min(profiled, len(calls))},
        checks={"proofs_rejected": (len(rejected), 0)},
        device=device,
        breakdown=tr.breakdown(summary) if summary else None,
        notes={"proofs": win.calls, "window_s": win.seconds},
    )
