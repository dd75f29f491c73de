"""verify.phase_a_ms: the tape's phase A a batch (`last_profile`'s `tape_phase_a`),
the mean over the traced window's batches."""

SPANS = ('tape_phase_a',)


def read(r):
    if r.get("entry") != "verify" or not r.get("spans"):
        return None
    total = sum(sum(s.get(k, 0.0) for k in SPANS) for s in r["spans"])
    return 1e3 * total / len(r["spans"])
