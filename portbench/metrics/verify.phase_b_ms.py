"""verify.phase_b_ms: phase B a batch (`last_profile`'s `phase_b1` and `phase_b2`),
the mean over the traced window's batches."""

SPANS = ('phase_b1', 'phase_b2')


def read(r):
    if r.get("entry") != "verify" or not r.get("spans"):
        return None
    total = sum(sum(s.get(k, 0.0) for k in SPANS) for s in r["spans"])
    return 1e3 * total / len(r["spans"])
