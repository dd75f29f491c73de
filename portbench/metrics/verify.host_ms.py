"""verify.host_ms: the verifier's host stages a batch (`BatchedVerifier.last_profile`: decompress,
pack_inputs, outer_squeeze, entry_points, combine, pairing), the mean over
the traced window's batches."""

SPANS = ('decompress', 'pack_inputs', 'outer_squeeze', 'entry_points', 'combine', 'pairing')


def read(r):
    if r.get("entry") != "verify" or not r.get("spans"):
        return None
    total = sum(sum(s.get(k, 0.0) for k in SPANS) for s in r["spans"])
    return 1e3 * total / len(r["spans"])
