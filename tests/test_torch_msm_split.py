"""The port's split bucket plan (ops/msm.py `bucket_plan_split`, built with
torch ops on the scalars' device, here the CPU) against the reference's
`ops/msm.host_bucket_plan_split`, and the accumulate twin over that plan
against the reference's gather (`msm_pallas.pregather16`, which feeds its
`_accum_kernel`) summed with its mixed-add rows, and the whole split MSM
against the native MSM. Exact equality throughout.

The reference's `msm_totals_pallas(..., interpret=True)` is not run: its
kernel body takes XLA:CPU many minutes to compile even in interpret mode
(tests/test_msm_pallas.py says so), so its row functions run eagerly here
instead, as the reference's own tests run them."""

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


def _uniform(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % ff.R for _ in range(n)]


def _top_heavy(rng, n):
    """Most scalars below 2^40: every window above bit 40 piles them into
    bucket 0, and the low windows carry all the load."""
    return [int(v) if i % 8 else int.from_bytes(rng.bytes(32), "little") % ff.R
            for i, v in enumerate(rng.integers(0, 1 << 40, size=n))]


CASES = {
    # name: (n, scalars, target, identity rows)
    "uniform": (300, _uniform, 8, ()),
    "top_heavy": (300, _top_heavy, 8, ()),
    "identity_rows": (300, _uniform, 8, (0, 7, 299)),
    # 4096 points in window 0's bucket 1: 1024 rows at target 4 plus one a
    # window above the cap, so the target doubles
    "all_ones": (4096, lambda rng, n: [1] * n, 4, ()),
    "default_target": (1200, _uniform, None, ()),
}


def _plan_inputs(case, c):
    n, make, target, ident = CASES[case]
    vals = make(np.random.default_rng(300 + c), n)
    for i in ident:
        vals[i] = 0  # msm_totals zeroes an identity row's scalar
    words = fo.ints_to_words(vals)
    return fo.to_tensor(words, "cpu"), fo.words_to_canonical16(words), target


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("c", [8, 4, 5])
def test_device_plan_matches_reference(case, c):
    """order and the unpadded rows of starts / counts / weights equal the
    reference's (its padding rows are empty), and so do the numpy copy's
    (the card tests' oracle), the raised target too; every lane holds at
    most `target` points."""
    scal, scal16, target = _plan_inputs(case, c)
    stats = {}
    got = pm.bucket_plan_split(scal, c, target, stats=stats)
    want = jmsm.host_bucket_plan_split(scal16, c, target)
    copy = pm.host_bucket_plan_split(scal16, c, target)
    rows = got[2].shape[0]
    assert stats["rows"] == rows and rows <= want[2].shape[0]
    for g, k, w in zip(got, copy, want):
        assert g.dtype == torch.int32 and k.dtype == np.int32
        assert np.array_equal(g.numpy(), w[:rows])
        assert np.array_equal(k, w[:rows])
    assert not want[2][rows:].any()
    assert stats["max_row_load"] == int(got[2].max()) <= stats["target"]
    if target is not None:
        assert stats["target"] >= target
    if case == "all_ones" and c == 8:
        assert stats["target"] == 8 and stats["max_load"] == 4096
    if case == "identity_rows":
        o, s, k, w = (t.long() for t in got)
        read = {int(o[w[r], s[r, b] + t]) for r in range(rows)
                for b in range(1 << c) for t in range(int(k[r, b]))}
        assert read.isdisjoint(CASES[case][3])


def _rows(vals, lanes):
    """Canonical Montgomery Fq ints -> the Pallas row form: 16 (1, lanes)
    uint32 limb rows."""
    limbs = jfo.ints_to_limbs([v * (1 << 256) % ff.P for v in vals])
    return [jnp.asarray(limbs[:, k].reshape(1, lanes)) for k in range(16)]


def _rows_to_words(rows):
    limbs = np.concatenate([np.asarray(r).reshape(-1, 1) for r in rows], axis=1)
    return fo.to_tensor(fo.ints_to_words(jfo.limbs_to_ints(limbs)), "cpu")


def test_accumulate_matches_reference_rows():
    """The twin over a split plan (4 rows of window 0 among others, 2
    steps) against
    the reference's accumulate steps: `pregather16` with the rows' windows
    gathers step t's point of every lane, `_mixed_add` adds it where t <
    count, word for word."""
    rng = np.random.default_rng(42)
    n, c, target = 40, 4, 2
    pts = [ff.g1_mul(ff.G1_GEN, int(rng.integers(1, 1 << 62))) for _ in range(n)]
    vals = _uniform(rng, n)
    vals[:8] = [1] * 8  # window 0's bucket 1 holds 8 points or more
    scal = fo.to_tensor(fo.ints_to_words(vals), "cpu")
    order, starts, counts, weights = pm.bucket_plan_split(scal, c, target)
    assert int((weights == 0).sum()) >= 4
    tx, ty, _ident = pm.affine_table(cv.from_affine_ints(pts, "cpu"))
    got = pm.accumulate(tx, ty, order, starts, counts, weights)

    jx = jnp.asarray(jfo.ints_to_limbs([p[0] * (1 << 256) % ff.P for p in pts]))
    jy = jnp.asarray(jfo.ints_to_limbs([p[1] * (1 << 256) % ff.P for p in pts]))
    steps = int(counts.max())
    px, py = mp.pregather16(jx, jy, jnp.asarray(order.numpy()),
                            jnp.asarray(starts.numpy()), jnp.int32(0), steps,
                            jnp.asarray(weights.numpy()))
    cnt = counts.reshape(-1).numpy()
    busy = np.nonzero(cnt)[0]  # the reference's steps on the lanes with points
    lanes = len(busy)
    acc = (_rows([0] * lanes, lanes), _rows([1] * lanes, lanes),
           _rows([0] * lanes, lanes))
    for t in range(steps):
        q = ([px[t, k, busy][None] for k in range(16)],
             [py[t, k, busy][None] for k in range(16)])
        new = mp._mixed_add(acc, q)
        live = jnp.asarray(cnt[busy] > t)[None]
        acc = tuple([jnp.where(live, a, b) for a, b in zip(na, oa)]
                    for na, oa in zip(new, acc))
    want = torch.stack([_rows_to_words(comp) for comp in acc], dim=1)
    assert torch.equal(got[busy], want)
    ident = torch.stack(cv.from_affine_ints([None], "cpu"), dim=1)
    assert torch.equal(got[cnt == 0], ident.expand(int((cnt == 0).sum()), 3, 8))


@pytest.mark.parametrize("n,c,target", [(200, 4, 4), (150, 5, 3)])
def test_split_msm_matches_native(n, c, target):
    """accumulate -> reduce over every row -> combine_rows_host, with an
    identity point whose scalar is nonzero, equals the native MSM; the
    small target splits the windows into several rows (c = 8 with one row
    a window: tests/test_torch_msm.py::test_twin_msm_matches_native; c = 8
    split: the card tests, where the reduce over 256 buckets is cheap)."""
    rng = np.random.default_rng(70 + n)
    pts = [ff.g1_mul(ff.G1_GEN, int(rng.integers(1, 1 << 62))) for _ in range(n)]
    vals = _uniform(rng, n)
    pts[5] = None
    table = pm.affine_table(cv.from_affine_ints(pts, "cpu"))
    stats, phases = {}, []
    totals, weights = pm.msm_totals(table, fo.to_tensor(fo.ints_to_words(vals), "cpu"),
                                    c, target, stats=stats, lap=phases.append)
    windows = -(-256 // c)
    assert stats["rows"] > windows and stats["max_row_load"] <= target
    assert totals.shape == (stats["rows"], 3, 8) and weights.shape == (stats["rows"],)
    assert phases == ["plan", "accumulate", "reduce"]
    want = ff.g1_msm([p for p in pts if p is not None],
                     [s for p, s in zip(pts, vals) if p is not None])
    assert pm.combine_rows_host(totals.unbind(1), weights, c) == want


def _corrupt(plan, fault):
    order, starts, counts, weights = (t.clone() for t in plan)
    lane = int(torch.nonzero(counts.reshape(-1))[0])
    r, b = divmod(lane, counts.shape[1])
    if fault == "weight_past_windows":
        weights[-1] = order.shape[0]
    elif fault == "negative_weight":
        weights[0] = -1
    elif fault == "lane_past_n":
        starts[r, b] = order.shape[1] - counts[r, b] + 1
    elif fault == "negative_start":
        starts[r, b] = -1
    else:  # negative_count
        counts[r, b] = -1
    return order, starts, counts, weights


@pytest.mark.parametrize("fault", ["weight_past_windows", "negative_weight",
                                   "lane_past_n", "negative_start",
                                   "negative_count"])
def test_accumulate_rejects_plan_out_of_bounds(fault):
    """The wrapper checks the plan's values, not only its shapes: a row's
    window outside order, or a lane reading outside the N points, raises
    before any add (the kernel reads the plan unchecked)."""
    rng = np.random.default_rng(44)
    n = 24
    pts = [ff.g1_mul(ff.G1_GEN, int(rng.integers(1, 1 << 62))) for _ in range(n)]
    tx, ty, _ident = pm.affine_table(cv.from_affine_ints(pts, "cpu"))
    plan = pm.bucket_plan_split(fo.to_tensor(fo.ints_to_words(_uniform(rng, n)), "cpu"),
                                4, 2)
    pm.accumulate(tx, ty, *plan)  # the plan itself passes
    with pytest.raises(ValueError, match="outside"):
        pm.accumulate(tx, ty, *_corrupt(plan, fault))


def test_combine_rows_host_sums_weighted_rows():
    """Rows of one window add up; identity rows drop out."""
    rng = np.random.default_rng(43)
    pts = [ff.g1_mul(ff.G1_GEN, int(rng.integers(1, 1 << 62))) for _ in range(4)]
    rows = pts[:3] + [None]
    weights = [0, 0, 5, 2]
    totals = cv.from_affine_ints(rows, "cpu")
    want = ff.g1_msm(pts[:3], [1, 1, pow(2, 8 * 5, ff.R)])
    assert pm.combine_rows_host(totals, torch.tensor(weights, dtype=torch.int32), 8) == want
    assert pm.combine_rows_host(totals, weights, 8) == want
    assert pm.combine_rows_host(cv.from_affine_ints([None], "cpu"), [0], 8) is None
