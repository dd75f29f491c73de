"""The port's CUDA kernels against their plain twins, on a card.

Marked `cuda`: without a card every test here skips (the decision is made
inside the `cuda` fixture, never at import). On a card:

    python -m pytest tests/ -q -m cuda
"""

import numpy as np
import pytest
import torch

from halo2_snark_aggregator_tpu_torch.circuits.zkevm import ZkevmShapeCircuit
from halo2_snark_aggregator_tpu_torch.ff import bn254 as ff
from halo2_snark_aggregator_tpu_torch.kernels import build
from halo2_snark_aggregator_tpu_torch.ops import curve as cv
from halo2_snark_aggregator_tpu_torch.ops import field as fo
from halo2_snark_aggregator_tpu_torch.ops import msm as pm
from halo2_snark_aggregator_tpu_torch.ops import ntt as pn
from halo2_snark_aggregator_tpu_torch.ops import poseidon as po
from halo2_snark_aggregator_tpu_torch.prover import accel, srs
from halo2_snark_aggregator_tpu_torch.prover.kzg import ParamsKZG
from halo2_snark_aggregator_tpu_torch.transcript.host import PoseidonWrite

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda")


def _rand(spec, shape, seed, device):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(32), "little") % spec.modulus for _ in range(n)]
    vals = ([0, 1, spec.modulus - 1] + vals[3:])[:n]
    return fo.mont_words(spec, vals, device).reshape(*shape, 8)


@pytest.mark.parametrize("mode", [fo.MUL, fo.ADD, fo.SUB, fo.POW])
@pytest.mark.parametrize("spec", [fo.FR, fo.FQ], ids=["Fr", "Fq"])
def test_field_kernel_matches_twin(cuda, spec, mode):
    a = _rand(spec, (40, 5), 1, cuda)
    b = _rand(spec, (40, 5), 2, cuda)
    idx = [torch.from_numpy(np.random.default_rng(s).permutation(40)[:17]
                            .astype(np.int32)).to(cuda) for s in (3, 4, 5)]
    out_k, out_p = torch.zeros_like(a), torch.zeros_like(a)
    before = build.LAUNCHES["field"]
    fo.field_op(mode, spec, a, b, a_idx=idx[0], b_idx=idx[1], out=out_k,
                out_idx=idx[2], exponent=spec.modulus - 2)
    assert build.LAUNCHES["field"] == before + 1
    fo.field_op_plain(mode, spec, 17, a, b, idx[0], idx[1], False, out_p,
                      idx[2], spec.modulus - 2)
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_p)


@pytest.mark.parametrize("spec", [fo.FR, fo.FQ], ids=["Fr", "Fq"])
def test_field_kernel_to_mont_unreduced(cuda, spec):
    """std -> Montgomery (MUL by R^2 in standard form) on operands up to
    2^256 - 1, as phase A's input conversion gives it Fq coordinates."""
    rng = np.random.default_rng(8)
    vals = [(1 << 256) - 1, ff.P, ff.R, 2 * ff.R, ff.P - 1, 0]
    vals += [int.from_bytes(rng.bytes(32), "little") for _ in range(26)]
    a = fo.to_tensor(fo.ints_to_words(vals), cuda).reshape(-1, 1, 8)
    r2 = fo.const(spec, spec.r2, cuda, mont=False)
    zeros = torch.zeros(len(vals), dtype=torch.int32, device=cuda)
    got = fo.field_op(fo.MUL, spec, a, r2, b_idx=zeros, b_bcast=True)
    want = torch.empty_like(a)
    fo.field_op_plain(fo.MUL, spec, len(vals), a, r2, None, zeros, True,
                      want, None, None)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert fo.from_mont_words(spec, got) == [v % spec.modulus for v in vals]


def _chain(n_calls, seed):
    """A random call table: 9 start rows, 16 input rows, then fresh output
    rows. Each call reads the start rows or an earlier call's output, takes
    0..8 inputs (the pad marker after them when short), and writes fresh
    rows or, in place, a permutation of the rows it read."""
    rng = np.random.default_rng(seed)
    st, n_in, pad, out = [], [], [], []
    ins = np.zeros((n_calls, 8), np.int64)
    states, rows = [list(range(9))], 25
    for j in range(n_calls):
        src = states[int(rng.integers(len(states)))]
        k = int(rng.integers(0, 9))
        ins[j, :k] = rng.choice(np.arange(9, 25), size=k, replace=False)
        if rng.random() < 0.3:
            dst = [int(r) for r in rng.permutation(src)]
        else:
            dst, rows = list(range(rows, rows + 9)), rows + 9
        st.append(src)
        n_in.append(k)
        pad.append(1 + k if k < 8 else -1)
        out.append(dst)
        states.append(dst)
    return (st, ins, n_in, pad, out), rows


@pytest.mark.parametrize("lanes", [1, 5, 128])
@pytest.mark.parametrize("n_calls", [1, 3, 30])
def test_poseidon_kernel_matches_twin(cuda, n_calls, lanes):
    """The chain kernel in one launch against its twin (on the CPU, where
    the twin's many small ops run faster) over a random call table."""
    table, rows = _chain(n_calls, 100 * n_calls + lanes)
    slots = _rand(fo.FR, (rows, lanes), 6, cuda)
    want = slots.cpu()
    po.sponge_chain_plain(want, po.chain_table(*table, "cpu"))
    before = build.LAUNCHES["poseidon"]
    po.sponge_chain(slots, po.chain_table(*table, cuda))
    assert build.LAUNCHES["poseidon"] == before + 1
    assert torch.equal(slots.cpu(), want)


def _sweep(acc, windows, nbuckets):
    """The serial reduce: per window, b = B-1..1, running += S_b; total +=
    running (tests/test_torch_msm.py keeps the same oracle)."""
    b = acc.reshape(windows, nbuckets, 3, 8)
    one = fo.const(fo.FQ, 1, acc.device)
    zero = torch.zeros(windows, 8, dtype=torch.int32, device=acc.device)
    running = total = (zero, one.expand(windows, 8), zero)
    for k in range(nbuckets - 1, 0, -1):
        running = cv.full_add(running, b[:, k].unbind(1))
        total = cv.full_add(total, running)
    return torch.stack(total, dim=1)


@pytest.mark.parametrize("c", [8, 4])
def test_msm_kernels_match_twins(cuda, c):
    """Split plan built on the card (target 4: several rows a window),
    accumulate and reduce against their twins, the row combine against the
    native MSM."""
    rng = np.random.default_rng(7)
    n = 300
    pts = [ff.g1_mul(ff.G1_GEN, int(rng.integers(1, 1 << 62))) for _ in range(n)]
    scal = [int.from_bytes(rng.bytes(32), "little") % ff.R for _ in range(n)]
    tx, ty, _ident = pm.affine_table(cv.from_affine_ints(pts, cuda))
    plan = pm.bucket_plan_split(fo.to_tensor(fo.ints_to_words(scal), cuda), c, 4)
    rows, nb = plan[2].shape
    assert rows > -(-256 // c)
    acc = pm.accumulate(tx, ty, *plan)
    assert torch.equal(acc, pm.accumulate_plain(tx, ty, *plan))
    tot = pm.reduce(acc, rows, nb)
    assert torch.equal(tot, pm.reduce_plain(acc, rows, nb))
    got = pm.combine_rows_host(tot.unbind(1), plan[3], c)
    assert got == ff.g1_msm(pts, scal)


@pytest.mark.parametrize("kind", ["uniform", "all_ones"])
def test_accumulate_split_matches_twin(cuda, kind):
    """The accumulate kernel word for word against its twin on the split
    plan at 2^12 SRS points (c = 8, the default target): uniform scalars
    (the top window in several rows), and all ones (one bucket of 4096
    points in 64 rows)."""
    n = 1 << 12
    params = srs.unsafe_setup_accel(12, device=cuda)
    tx, ty, _ident = params.table()
    rng = np.random.default_rng(15)
    vals = ([int.from_bytes(rng.bytes(32), "little") % ff.R for _ in range(n)]
            if kind == "uniform" else [1] * n)
    stats = {}
    plan = pm.bucket_plan_split(fo.to_tensor(fo.ints_to_words(vals), cuda), 8,
                                stats=stats)
    assert stats["max_row_load"] <= pm.default_target(n, 8) < stats["max_load"]
    before = build.LAUNCHES["msm_accumulate"]
    acc = pm.accumulate(tx, ty, *plan)
    assert build.LAUNCHES["msm_accumulate"] == before + 1
    assert torch.equal(acc, pm.accumulate_plain(tx, ty, *plan))
    tot = pm.reduce(acc, *plan[2].shape)
    got = pm.combine_rows_host(tot.unbind(1), plan[3], 8)
    assert got == ff.g1_msm(params.g_host_points(), vals)


def test_device_plan_matches_host_copy_2e16(cuda):
    """The split plan built on the card equals the numpy copy's at the
    prover's commit size."""
    rng = np.random.default_rng(16)
    words = fo.ints_to_words([int.from_bytes(rng.bytes(32), "little") % ff.R
                              for _ in range(1 << 16)])
    got = pm.bucket_plan_split(fo.to_tensor(words, cuda), 8)
    want = pm.host_bucket_plan_split(fo.words_to_canonical16(words), 8)
    for g, w in zip(got, want):
        assert g.is_cuda and np.array_equal(g.cpu().numpy(), w)


def test_k16_device_commit_matches_native(cuda):
    """One K=16 device commit (the prover's path: scalars stay on the
    card) equals the native MSM of the same coefficients."""
    params = srs.unsafe_setup_accel(16, device=cuda)
    params.commit_mode = "device"
    rng = np.random.default_rng(17)
    vals = [int.from_bytes(rng.bytes(32), "little") % ff.R
            for _ in range(params.n - 5)]  # zero-padded to n on the card
    params.commit_log = []
    got = params.commit_coeff_mont(accel.ints_to_mont(vals, cuda))
    (rec,) = params.commit_log
    assert rec["mode"] == "device" and rec["max_row_load"] <= 128
    assert list(rec["split_s"]) == ["scalars", "plan", "accumulate", "reduce",
                                    "combine"]
    assert got == ff.g1_msm(params.g_host_points()[: len(vals)], vals)


@pytest.mark.parametrize("windows,nbuckets", [(32, 256), (3, 16), (2, 600)])
def test_reduce_kernel_matches_twin(cuda, windows, nbuckets):
    """The scan reduce word for word against its twin, and in affine form
    against the serial sweep, on projective buckets with identities and
    repeats (600 buckets: 3 positions a thread)."""
    rng = np.random.default_rng(windows + nbuckets)
    m = windows * nbuckets
    pts = [ff.g1_mul(ff.G1_GEN, int(rng.integers(1, 1 << 62))) for _ in range(64)]
    a = [pts[int(i)] for i in rng.integers(64, size=m)]
    b = [pts[int(i)] for i in rng.integers(64, size=m)]
    a[1] = b[1] = None
    acc = cv.padd(torch.stack(cv.from_affine_ints(a, cuda), dim=1),
                  torch.stack(cv.from_affine_ints(b, cuda), dim=1))
    before = build.LAUNCHES["msm_reduce"]
    tot = pm.reduce(acc, windows, nbuckets)
    assert build.LAUNCHES["msm_reduce"] == before + 1
    assert torch.equal(tot, pm.reduce_plain(acc, windows, nbuckets))
    assert (cv.to_affine_ints(tot.unbind(1))
            == cv.to_affine_ints(_sweep(acc, windows, nbuckets).unbind(1)))


def test_padd_kernel_matches_twin(cuda):
    rng = np.random.default_rng(11)
    pts = [ff.g1_mul(ff.G1_GEN, int(rng.integers(1, 1 << 62))) for _ in range(200)]
    a = pts + [None, pts[0], None, pts[1], pts[2]]
    b = pts[::-1] + [pts[3], None, None, pts[1], ff.g1_neg(pts[2])]
    pa = torch.stack(cv.from_affine_ints(a, cuda), dim=1)
    pb = torch.stack(cv.from_affine_ints(b, cuda), dim=1)
    before = build.LAUNCHES["curve_padd"]
    got = cv.padd(pa, pb)
    assert build.LAUNCHES["curve_padd"] == before + 1
    assert torch.equal(got, cv.padd_plain(pa, pb))
    twice = cv.padd(got, got)  # projective inputs (z != 1)
    assert torch.equal(twice, cv.padd_plain(got, got))
    assert cv.to_affine_ints(got.unbind(1)) == [ff.g1_add(p, q)
                                                for p, q in zip(a, b)]


_FB_SCALARS = [0, 1, ff.R - 1, (0x01 << 248) | (0x0203 << 120) | 0x04,
               (1 << 256) - 1, 0xff << 128]


@pytest.mark.parametrize("n", [75, 1000])
def test_fixed_base_kernel_matches_twin(cuda, n):
    """The fixed-base kernel word for word against its twin on special
    scalars (0, 1, r - 1, zero digits inside, all 32 digits 0xff, one
    nonzero digit) and random ones, n scalars (a partial last block);
    affine sums == host."""
    rng = np.random.default_rng(21)
    scal = _FB_SCALARS + [int.from_bytes(rng.bytes(32), "little")
                          for _ in range(n - len(_FB_SCALARS))]
    sw = fo.to_tensor(fo.ints_to_words(scal), cuda)
    table = srs.g1_table(cuda)
    before = build.LAUNCHES["fixed_base"]
    got = cv.fixed_base(sw, table)
    assert build.LAUNCHES["fixed_base"] == before + 1
    want = cv.fixed_base_plain(sw, table)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert cv.to_affine_ints(got[:75].unbind(1)) == [
        ff.g1_mul(ff.G1_GEN, v) if v % ff.R else None for v in scal[:75]]


def test_unsafe_setup_accel_on_card(cuda):
    """The SRS on the card: one fixed-base launch, no padd launch, the
    table the CPU setup makes, word for word."""
    k = 8
    before = dict(build.LAUNCHES)
    params = srs.unsafe_setup_accel(k, lagrange_prefix=4, device=cuda)
    assert build.LAUNCHES["fixed_base"] == before["fixed_base"] + 1
    assert build.LAUNCHES["curve_padd"] == before["curve_padd"]
    host = srs.unsafe_setup_accel(k, lagrange_prefix=4, device="cpu")
    assert torch.equal(params.g_dev.cpu(), host.g_dev)


@pytest.mark.parametrize("k,b,with_coset", [(4, 1, False), (11, 3, False),
                                             (16, 8, True)])
def test_ntt_butterfly_matches_twin(cuda, k, b, with_coset):
    """The batched transform kernel (one launch a pass) against its twin,
    forward and inverse, word for word: one pass of small tiles, two passes
    of small tiles, and two passes of four groups a block at k = 16."""
    x = _rand(fo.FR, (b, 1 << k), 12, cuda)
    coset = _rand(fo.FR, (1 << k,), 13, cuda) if with_coset else None
    for inverse in (False, True):
        before = build.LAUNCHES["ntt_transform"]
        got = pn.ntt_batch(x, k, inverse, coset=coset)
        assert build.LAUNCHES["ntt_transform"] == before + len(pn.pass_bounds(k))
        want = pn.ntt_batch_plain(x, k, inverse, coset=coset)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_field_program_matches_twin(cuda):
    """The row-program kernel on the zkevm-shape (k = 7) quotient program
    of two proofs over random columns, against its twin."""
    from halo2_snark_aggregator_tpu_torch.protocol.plonk import ConstraintSystem
    from halo2_snark_aggregator_tpu_torch.prover import quotient_program as qp

    cs = ConstraintSystem()
    ZkevmShapeCircuit(k=7, seed=3, n_groups=2, table_bits=6).configure(cs)
    rng = np.random.default_rng(15)
    ch = [int.from_bytes(rng.bytes(32), "little") % ff.R
          for _ in range(cs.num_challenges + 4)]
    prog, keys = qp.compile_quotient(cs, 2, ch[4:], *ch[:4])
    cols = list(_rand(fo.FR, (len(keys), 1 << 7), 16, cuda).unbind(0))
    before = build.LAUNCHES["field_program"]
    got = fo.run_program(prog, cols)
    assert build.LAUNCHES["field_program"] == before + 1
    want = fo.run_program_plain(prog, cols)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_ntt_scale_and_transform(cuda):
    """The inverse transform scales by 1/n in its last pass: one launch a
    pass, no scale launch (one pass at k = 10, two at k = 12), equal to the
    twin word for word; inverse(forward) is the input."""
    assert "ntt_scale" not in build.LAUNCHES
    for k in (10, 12):
        x = _rand(fo.FR, (2, 1 << k), 14, cuda)
        pn.device_plan(k, True, x.device)  # built once, by the field kernel
        before = dict(build.LAUNCHES)
        got = pn.ntt_batch(x, k, inverse=True)
        assert {n: c - before[n] for n, c in build.LAUNCHES.items()
                if c != before[n]} == {"ntt_transform": len(pn.pass_bounds(k))}
        assert torch.equal(got, pn.ntt_batch_plain(x, k, inverse=True))
        fwd = pn.ntt_auto(x[0], k)
        assert torch.equal(fwd.cpu(), pn.ntt_auto(x[0].cpu(), k))
        assert torch.equal(pn.ntt_auto(fwd, k, inverse=True), x[0])


def test_zkevm_k7_proof_on_card(cuda):
    """keygen and proof on the card with device commits (window 8) write
    the bytes of the CPU run with host commits."""
    k = 7

    def circuit(seed):
        return ZkevmShapeCircuit(k=k, seed=seed, n_groups=2, table_bits=6)

    params = ParamsKZG.unsafe_setup(k)
    proofs = []
    for dev, mode in (("cpu", "host"), (cuda, "device")):
        ap = accel.AccelParams.from_params(params, mode, device=dev)
        _vk, apk = accel.keygen_accel(circuit(1), k, ap)
        c = circuit(2)
        proofs.append(accel.create_proof_accel(apk, ap, [c], [c.instances()],
                                               PoseidonWrite(), seed=3))
    assert proofs[0] == proofs[1]


@pytest.mark.parametrize("k", [16, 18])
def test_ntt_plan_built_on_card_equals_host_plan(cuda, k):
    """The twiddles built by doubling through the field kernel and the bit
    reversal as tensor ops equal the host plan word for word."""
    for inverse in (False, True):
        rev, tw = pn.device_tables(k, inverse, cuda)
        h_rev, h_tw, _ = pn._plan(k, inverse)
        assert np.array_equal(rev.cpu().numpy(), h_rev)
        assert np.array_equal(fo.to_numpy(tw), h_tw)


def test_tau_powers_words_on_card(cuda):
    k = 18
    got = srs.tau_powers_words(k, cuda)
    want = fo.to_tensor(fo.ints_to_words(srs.tau_powers(k)), cuda)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 300, 5000])
def test_msm_ints_on_card_matches_native(cuda, n):
    """The hybrid chips' ints-in MSM on the card (split plan, accumulate,
    reduce, host row combine) against the native g1_msm, with an identity
    point and a zero scalar, and against the same call on the CPU twins."""
    rng = np.random.default_rng(n)
    pts = [ff.g1_mul(ff.G1_GEN, int(rng.integers(1, 1 << 62))) for _ in range(n)]
    scal = [int.from_bytes(rng.bytes(32), "little") % ff.R for _ in range(n)]
    if n > 1:
        pts[1] = None
        scal[0] = 0
    want = ff.g1_msm([p for p in pts if p is not None],
                     [s for p, s in zip(pts, scal) if p is not None])
    before = build.LAUNCHES["msm_accumulate"]
    assert pm.msm_ints(pts, scal, device=cuda) == want
    assert build.LAUNCHES["msm_accumulate"] == before + 1
    if n <= 300:
        assert pm.msm_ints(pts, scal, device="cpu") == want
