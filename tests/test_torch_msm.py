"""The port's MSM layer (ops/msm.py, ops/curve.py) against the reference:
the planner copy against `ops/msm.host_bucket_plan`, the curve twins
against the Pallas kernels' row functions `msm_pallas._mixed_add` /
`_full_add` run eagerly (as tests/test_msm_pallas.py runs them), the
scan reduce against host sums sum_b b * S_b (`ff/bn254`) and against the
serial running-sum sweep, and the whole twin MSM (plan -> accumulate ->
reduce -> combine) against the native MSM. Exact equality throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_snark_aggregator_tpu.ff import bn254 as ff
from halo2_snark_aggregator_tpu.ops import field as jfo
from halo2_snark_aggregator_tpu.ops import msm as jmsm
from halo2_snark_aggregator_tpu.ops import msm_pallas as mp
from halo2_snark_aggregator_tpu_torch.ops import curve as cv
from halo2_snark_aggregator_tpu_torch.ops import field as fo
from halo2_snark_aggregator_tpu_torch.ops import msm as pm


def _scalars(seed, n):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % ff.R for _ in range(n)]
    vals[:3] = [0, 1, ff.R - 1]
    return vals


def _points(seed, n):
    rng = np.random.default_rng(seed)
    return [ff.g1_mul(ff.G1_GEN, int(rng.integers(1, 1 << 62))) for _ in range(n)]


@pytest.mark.parametrize("c", [8, 4, 5])
def test_planner_matches_reference(c):
    """The numpy plain-plan copy (the split copy's base) and the device
    digits against the reference."""
    vals = _scalars(40 + c, 300)
    scal = jfo.ints_to_std(vals)
    want = jmsm.host_bucket_plan(scal, c)
    got = pm.host_bucket_plan(scal, c)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    words = fo.to_tensor(fo.ints_to_words(vals), "cpu")
    assert np.array_equal(pm.scalar_digits(words, c).numpy(),
                          np.asarray(jmsm.scalar_digits(jnp.asarray(scal), c)))


def _rows(vals, lanes):
    """Canonical Montgomery Fq ints -> the Pallas row form: 16 (1, lanes)
    uint32 limb rows."""
    limbs = jfo.ints_to_limbs([v * (1 << 256) % ff.P for v in vals])
    return [jnp.asarray(limbs[:, k].reshape(1, lanes)) for k in range(16)]


def _rows_to_words(rows):
    limbs = np.concatenate([np.asarray(r).reshape(-1, 1) for r in rows], axis=1)
    mont = jfo.limbs_to_ints(limbs)
    return fo.to_tensor(fo.ints_to_words(mont), "cpu")


def _proj(pts):
    """Affine points (None = identity) -> projective coordinate int lists."""
    return ([0 if p is None else p[0] for p in pts],
            [1 if p is None else p[1] for p in pts],
            [0 if p is None else 1 for p in pts])


def _cases():
    p1, p2 = _points(50, 2)
    return p1, p2, [(p1, p2), (p1, p1), (p1, ff.g1_neg(p1)), (None, p2),
                    (p1, None), (None, None)]


def test_mixed_add_matches_pallas_rows():
    """Generic, doubling, inverse and identity-accumulator lanes (q is never
    the identity: the plan never reads an identity row)."""
    _p1, _p2, cases = _cases()
    cases = [(a, b) for a, b in cases if b is not None]
    lanes = len(cases)
    acc = _proj([a for a, _ in cases])
    q = _proj([b for _, b in cases])
    want = mp._mixed_add(tuple(_rows(c, lanes) for c in acc),
                         (_rows(q[0], lanes), _rows(q[1], lanes)))
    acc_w = tuple(fo.mont_words(fo.FQ, c, "cpu") for c in acc)
    got = cv.mixed_add(acc_w, fo.mont_words(fo.FQ, q[0], "cpu"),
                       fo.mont_words(fo.FQ, q[1], "cpu"))
    for g, w in zip(got, want):
        assert torch.equal(g, _rows_to_words(w))
    assert cv.to_affine_ints(got) == [ff.g1_add(a, b) for a, b in cases]


def test_full_add_matches_pallas_rows():
    _p1, _p2, cases = _cases()
    lanes = len(cases)
    a = _proj([x for x, _ in cases])
    b = _proj([y for _, y in cases])
    want = mp._full_add(tuple(_rows(c, lanes) for c in a),
                        tuple(_rows(c, lanes) for c in b))
    got = cv.full_add(tuple(fo.mont_words(fo.FQ, c, "cpu") for c in a),
                      tuple(fo.mont_words(fo.FQ, c, "cpu") for c in b))
    for g, w in zip(got, want):
        assert torch.equal(g, _rows_to_words(w))
    assert cv.to_affine_ints(got) == [ff.g1_add(x, y) for x, y in cases]


@pytest.mark.parametrize("n,c", [(1, 8), (7, 8), (64, 8), (256, 8), (300, 8),
                                 (200, 4)])
def test_twin_msm_matches_native(n, c):
    """`msm_ints` on the CPU (split plan -> accumulate -> reduce -> row
    combine, the twins) against the native MSM, with an identity point and
    a zero scalar among the inputs (at n = 1, one point with r - 1)."""
    pts = _points(60 + n, n)
    scal = _scalars(70 + n, n)  # scal[0] = 0
    if n == 1:
        scal = [ff.R - 1]
    else:
        pts[5 % n] = None  # an identity point with a nonzero scalar is skipped
    want = ff.g1_msm([p for p in pts if p is not None],
                     [s for p, s in zip(pts, scal) if p is not None])
    assert want is not None
    assert pm.msm_ints(pts, scal, c, device="cpu") == want


def test_msm_ints_edges():
    assert pm.msm_ints([], [], device="cpu") is None
    with pytest.raises(ValueError):
        pm.msm_ints([ff.G1_GEN], [1, 2], device="cpu")


def _sweep(acc, windows, nbuckets):
    """The serial reduce (the TPU kernel's order): per window, b = B-1..1,
    running += S_b; total += running."""
    b = fo.halves(acc.reshape(windows, nbuckets, 3, 8))
    one = fo.halves(fo.const(fo.FQ, 1, "cpu"))
    zero = torch.zeros(windows, 16, dtype=torch.int64)
    running = total = (zero, one.expand(windows, 16), zero)
    for k in range(nbuckets - 1, 0, -1):
        running = cv.full_add_h(running, tuple(b[:, k, i] for i in range(3)))
        total = cv.full_add_h(total, running)
    return torch.stack([fo.words(c) for c in total], dim=1)


@pytest.mark.parametrize("windows,nbuckets", [(2, 2), (3, 16), (2, 256), (2, 600)])
def test_reduce_matches_host_sum(windows, nbuckets):
    """Projective buckets (random z, identities as (0 : z : 0)) with
    identity and repeated buckets: the scan reduce's totals equal
    sum_b b * S_b on host ints and the serial sweep's, in affine form
    (600 buckets: 3 positions a thread, the segment steps of the scan)."""
    rng = np.random.default_rng(90 + nbuckets)
    m = windows * nbuckets
    bucket = _points(91 + nbuckets, m)
    for i in rng.choice(m, size=max(m // 4, 1), replace=False):
        bucket[i] = bucket[int(rng.integers(m))]  # repeated buckets
    bucket[1] = bucket[-1] = None
    lam = [int(rng.integers(1, 1 << 62)) for _ in range(m)]
    coords = ([0 if p is None else p[0] * z % ff.P for p, z in zip(bucket, lam)],
              [z if p is None else p[1] * z % ff.P for p, z in zip(bucket, lam)],
              [0 if p is None else z for p, z in zip(bucket, lam)])
    acc = torch.stack([fo.mont_words(fo.FQ, c, "cpu") for c in coords], dim=1)
    want = []
    for w in range(windows):
        rows = [(b, bucket[w * nbuckets + b]) for b in range(1, nbuckets)]
        rows = [(b, p) for b, p in rows if p is not None]
        want.append(ff.g1_msm([p for _, p in rows], [b for b, _ in rows])
                    if rows else None)
    got = pm.reduce(acc, windows, nbuckets)
    assert cv.to_affine_ints(got.unbind(1)) == want
    assert cv.to_affine_ints(_sweep(acc, windows, nbuckets).unbind(1)) == want


def test_reduce_shape():
    """One position a thread up to 257 buckets; wider windows share out
    ceil(n / 256) positions a thread, every thread's segment starting
    below n."""
    assert pm.reduce_shape(2) == (1, 1)
    assert pm.reduce_shape(16) == (15, 1)
    assert pm.reduce_shape(256) == (255, 1)
    assert pm.reduce_shape(257) == (256, 1)
    for nb in (258, 600, 1 << 14):
        nt, seg = pm.reduce_shape(nb)
        assert nt <= pm.REDUCE_THREADS and (nt - 1) * seg < nb - 1 <= nt * seg


def test_affine_table_checks_every_row():
    pts = _points(80, 200)
    x, y, z = cv.from_affine_ints(pts + [None], "cpu")
    _x, _y, ident = pm.affine_table((x, y, z))
    assert ident.tolist() == [False] * 200 + [True]
    z = z.clone()
    z[137] = fo.mont_words(fo.FQ, [5], "cpu")[0]  # one projective row
    with pytest.raises(ValueError):
        pm.affine_table((x, y, z))


def test_from_to_affine_roundtrip():
    pts = _points(81, 7) + [None]
    assert cv.to_affine_ints(cv.from_affine_ints(pts, "cpu")) == pts


def test_decompress_matches_host_sqrt():
    rng = np.random.default_rng(82)
    pts = _points(83, 6)
    xs = [p[0] for p in pts]
    off = [int(rng.integers(1, 1 << 40)) for _ in range(6)]
    off = [x for x in off if ff.sqrt_mod_p((x ** 3 + 3) % ff.P) is None][:2]
    assert off
    ys = cv.decompress_g1_ys(xs + off, "cpu")
    for (x, y), got in zip(pts, ys[:6]):
        assert got in (y, ff.P - y)
    assert ys[6:] == [None] * len(off)


def test_kernel_wrappers_validate():
    t = torch.zeros((4, 8), dtype=torch.int32)
    plan = tuple(torch.zeros(s, dtype=torch.int32)
                 for s in ((2, 4), (3, 16), (3, 16), (3,)))
    assert pm.accumulate(t, t, *plan).shape == (48, 3, 8)
    with pytest.raises(ValueError):
        pm.accumulate(t, t[:3], *plan)
    for bad in (plan[3][:2], plan[3].long(), torch.zeros(6, dtype=torch.int32)[::2]):
        with pytest.raises(ValueError):  # weights: shape, type, layout
            pm.accumulate(t, t, *plan[:3], bad)
    with pytest.raises(ValueError):
        pm.bucket_plan_split(t.long(), 8)
    with pytest.raises(ValueError):
        pm.reduce(torch.zeros((31, 3, 8), dtype=torch.int32), 2, 16)
