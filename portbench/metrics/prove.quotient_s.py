"""prove.quotient_s: the quotient's row programs a proof (the port's `StageTimer` span
`quotient`, exclusive of nested spans), the mean over the traced window's proofs."""

SPANS = ('quotient',)


def read(r):
    if r.get("entry") != "prove" or not r.get("spans"):
        return None
    total = sum(sum(s.get(k, 0.0) for k in SPANS) for s in r["spans"])
    return 1.0 * total / len(r["spans"])
