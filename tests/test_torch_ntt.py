"""The port's NTT (ops/ntt.py) on the CPU, where the transform wrapper
runs its plain twin, against the reference: the JAX package's
host-exact NTT (prover/domain) and its `ntt_host_ints` at k = 4..8, and
its jnp `ops/ntt.ntt` on the same Montgomery words at k = 4 and 8 (each k
is a separate jit compile of a few seconds, so the jnp check takes the two
ends of the range). Forward and inverse, exact equality. The batched
transform's twin `ntt_batch_plain` runs the kernel's pass decomposition
at every split r of k = 4, 6, 8 on batches of 1 and 3 vectors, against
the reference column by column: the jnp `ntt` at k = 4 and 8 (the same
two compiles), the host-exact NTT at k = 6. The twins are also held to
the reference's stage semantics directly."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_snark_aggregator_tpu.ff import bn254 as ff
from halo2_snark_aggregator_tpu.ops import ntt as jntt
from halo2_snark_aggregator_tpu.prover import domain as jdomain
from halo2_snark_aggregator_tpu_torch import convert
from halo2_snark_aggregator_tpu_torch.ops import field as fo
from halo2_snark_aggregator_tpu_torch.ops import ntt as pn


def _values(seed: int, n: int) -> list[int]:
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % ff.R for _ in range(n)]
    return ([0, ff.R - 1] + vals[2:])[:n]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("k", [4, 5, 6, 7, 8])
def test_ntt_matches_reference(k, inverse):
    vals = _values(10 * k + inverse, 1 << k)
    got = pn.ntt_host_ints(vals, k, inverse)
    omega = jdomain.omega_for_k(k)
    host = jdomain.intt(vals, omega) if inverse else jdomain.ntt(vals, omega)
    assert got == host
    if k in (4, 8):
        assert got == jntt.ntt_host_ints(vals, k, inverse)
        mont = fo.mont_words(fo.FR, vals, "cpu")
        want = np.asarray(jntt.ntt(
            jnp.asarray(convert.canonical16_from_words(fo.to_numpy(mont))),
            k, inverse))
        out = pn.ntt_auto(mont, k, inverse)
        np.testing.assert_array_equal(convert.canonical16_from_words(
            fo.to_numpy(out)), want)


def test_plan_matches_reference():
    """Rev, every stage's twiddles and n^-1 equal the reference's `_plan`."""
    k = 6
    for inverse in (False, True):
        rev, tw, n_inv = pn._plan(k, inverse)
        jrev, jtw, jn_inv = jntt._plan(k, inverse)
        np.testing.assert_array_equal(rev, jrev)
        np.testing.assert_array_equal(
            convert.canonical16_from_words(tw),
            np.concatenate([np.asarray(t) for t in jtw]))
        if inverse:
            np.testing.assert_array_equal(
                convert.canonical16_from_words(n_inv), np.asarray(jn_inv))
        else:
            assert n_inv is None and jn_inv is None


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("k", [4, 8, 12])
def test_device_plan_equals_host_plan(k, inverse):
    """The plan built by `device_tables` (powers by doubling through the
    field kernel's twin here, the bit reversal as tensor ops) equals the
    host plan word for word, and `device_plan` caches it beside n^-1."""
    rev, tw = pn.device_tables(k, inverse, "cpu")
    h_rev, h_tw, h_inv = pn._plan(k, inverse)
    assert rev.dtype == torch.int64 and tw.dtype == torch.int32
    np.testing.assert_array_equal(rev.numpy(), h_rev)
    np.testing.assert_array_equal(fo.to_numpy(tw), h_tw)
    d_rev, d_tw, d_inv = pn.device_plan(k, inverse, torch.device("cpu"))
    assert torch.equal(d_rev, rev) and torch.equal(d_tw, tw)
    assert pn.device_plan(k, inverse, torch.device("cpu"))[1] is d_tw
    if inverse:
        np.testing.assert_array_equal(d_inv, h_inv)
    else:
        assert d_inv is None and h_inv is None


@pytest.mark.parametrize("half", [1, 4, 16])
def test_butterfly_twin_is_one_stage(half):
    """butterfly_plain on (n, 8) words = lo = u + v tw, hi = u - v tw per
    block, checked with Python ints."""
    n = 32
    vals = _values(half, n)
    tws = _values(100 + half, half)
    x = fo.mont_words(fo.FR, vals, "cpu")
    tw = fo.mont_words(fo.FR, tws, "cpu")
    pn.butterfly_plain(x, tw, half)
    got = fo.from_mont_words(fo.FR, x)
    want = list(vals)
    for b in range(0, n, 2 * half):
        for j in range(half):
            u, v = vals[b + j], vals[b + half + j] * tws[j] % ff.R
            want[b + j] = (u + v) % ff.R
            want[b + half + j] = (u - v) % ff.R
    assert got == want


def test_scale_twin():
    """scale_plain, the inverse's 1/n step (on the card, the last pass's
    epilogue), on one vector and on a batch of vectors."""
    vals = _values(7, 16)
    x = fo.mont_words(fo.FR, vals, "cpu")
    c = 1234567
    cw = fo.ints_to_words([fo.FR.to_mont_int(c)])[0]
    out = pn.scale_plain(x, cw)
    assert fo.from_mont_words(fo.FR, out) == [v * c % ff.R for v in vals]
    assert torch.equal(pn.scale_plain(torch.stack([x, out]), cw),
                       torch.stack([out, pn.scale_plain(out, cw)]))


def test_wrappers_refuse_bad_shapes():
    x = torch.zeros((16, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        pn.butterfly_plain(x, torch.zeros((3, 8), dtype=torch.int32), 3)
    with pytest.raises(ValueError):
        pn.ntt_batch(x[None].to(torch.int64), 4)
    with pytest.raises(ValueError):
        pn.ntt_batch(x, 4)
    with pytest.raises(ValueError):
        pn.ntt_batch(torch.zeros((2, 8, 16), dtype=torch.int32).transpose(1, 2), 4)
    with pytest.raises(ValueError):
        pn.ntt_batch(x[None], 4, coset=torch.zeros((8, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        pn.ntt_batch(x[None], 0)
    with pytest.raises(ValueError):
        pn.ntt_batch_plain(x[None], 4, r=0)
    with pytest.raises(ValueError):
        pn.ntt_batch(torch.zeros((pn.MAX_BATCH + 1, 2, 8), dtype=torch.int32), 1)
    with pytest.raises(ValueError):
        pn.ntt_auto(x, 5)
    with pytest.raises(ValueError):
        pn.ntt_batch(x[None, :, :4].contiguous(), 4, inverse=True)
    with pytest.raises(ValueError):
        pn.scale_plain(x[:, :4], np.zeros(8, np.uint32))


# -- the batched transform -----------------------------------------------------


def _batch(k: int, b: int) -> torch.Tensor:
    return torch.stack([fo.mont_words(fo.FR, _values(1000 * k + j, 1 << k), "cpu")
                        for j in range(b)])


@functools.lru_cache(maxsize=None)
def _reference_ntt(k: int, inverse: bool) -> np.ndarray:
    """The reference's NTT of each of the three columns of `_batch(k, 3)`,
    as (3, n, 8) words: its jnp `ntt` at k = 4 and 8, whose jit compiles
    `test_ntt_matches_reference` shares, and its host-exact NTT otherwise
    (a third k's compiles would cost ~5 s)."""
    x = _batch(k, 3)
    if k in (4, 8):
        out = [convert.words_from_canonical16(np.asarray(jntt.ntt(
            jnp.asarray(convert.canonical16_from_words(fo.to_numpy(col))), k,
            inverse))) for col in x]
        return np.stack(out)
    omega = jdomain.omega_for_k(k)
    step = jdomain.intt if inverse else jdomain.ntt
    return np.stack([fo.to_numpy(fo.mont_words(
        fo.FR, step(fo.from_mont_words(fo.FR, col), omega), "cpu"))
        for col in x])


@pytest.mark.parametrize("k,r", [(k, r) for k in (4, 6, 8)
                                 for r in range(1, k + 1)])
def test_ntt_batch_plain_matches_reference(k, r):
    """Every split r of the two-pass decomposition, batches of 1 and 3,
    forward and inverse, equals the reference word for word."""
    for b in (1, 3):
        x = _batch(k, b)
        for inverse in (False, True):
            got = pn.ntt_batch_plain(x, k, inverse, r)
            np.testing.assert_array_equal(fo.to_numpy(got),
                                          _reference_ntt(k, inverse)[:b])


@pytest.mark.parametrize("k,stages", [(1, 10), (5, 10), (7, 4), (7, 3)])
def test_ntt_batch_kernel_split(k, stages, monkeypatch):
    """The kernel's own passes (at most PASS_STAGES stages each, covering
    0 .. k: one pass at the default limit, two or three at k = 7 with the
    limit lowered to 4 or 3, as k = 16 or 22 split at 10) give the
    host-exact NTT, as `ntt_batch` runs them on the CPU."""
    monkeypatch.setattr(pn, "PASS_STAGES", stages)
    bounds = pn.pass_bounds(k)
    assert len(bounds) == -(-k // stages)
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(1 <= s1 - s0 <= stages for s0, s1 in bounds)
    x = _batch(k, 2)
    omega = jdomain.omega_for_k(k)
    for inverse in (False, True):
        got = pn.ntt_batch(x, k, inverse)
        for col, out in zip(x, got):
            vals = fo.from_mont_words(fo.FR, col)
            want = jdomain.intt(vals, omega) if inverse else jdomain.ntt(vals, omega)
            assert fo.from_mont_words(fo.FR, out) == want


def test_pass_bounds_at_prover_sizes():
    assert pn.pass_bounds(16) == [(0, 8), (8, 16)]
    assert pn.pass_bounds(18) == [(0, 9), (9, 18)]
    assert pn.pass_bounds(20) == [(0, 10), (10, 20)]
    assert pn.pass_bounds(22) == [(0, 8), (8, 15), (15, 22)]
    assert pn.pass_bounds(8) == [(0, 8)]
    assert pn.pass_bounds(16, r=11) == [(0, 11), (11, 16)]
    assert pn.pass_bounds(6, r=6) == [(0, 6)]


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_auto_is_batch_of_one(inverse):
    k = 6
    x = _batch(k, 1)
    assert torch.equal(pn.ntt_auto(x[0], k, inverse), pn.ntt_batch(x, k, inverse)[0])


def test_ntt_batch_coset_factor():
    """The coset factor multiplies each coefficient row before the
    transform: evaluations at zeta omega^i."""
    k = 5
    n = 1 << k
    x = _batch(k, 3)
    zeta = 7
    coset = fo.mont_words(fo.FR, [pow(zeta, i, ff.R) for i in range(n)], "cpu")
    got = pn.ntt_batch(x, k, coset=coset)
    omega = jdomain.omega_for_k(k)
    for col, out in zip(x, got):
        coeffs = fo.from_mont_words(fo.FR, col)
        want = [sum(c * pow(zeta * pow(omega, i, ff.R), j, ff.R)
                    for j, c in enumerate(coeffs)) % ff.R for i in range(n)]
        assert fo.from_mont_words(fo.FR, out) == want
