"""The port's NTT (ops/ntt.py) on the CPU, where the butterfly and scale
wrappers run their plain twins, against the reference: the JAX package's
host-exact NTT (prover/domain) and its `ntt_host_ints` at k = 4..8, and
its jnp `ops/ntt.ntt` on the same Montgomery words at k = 4 and 8 (each k
is a separate jit compile of a few seconds, so the jnp check takes the two
ends of the range). Forward and inverse, exact equality. The twins are
also held to the reference's stage semantics directly."""

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


@pytest.mark.parametrize("half", [1, 4, 16])
def test_butterfly_twin_is_one_stage(half):
    """butterfly_plain on (n, 8) words = lo = u + v tw, hi = u - v tw per
    block, checked with Python ints."""
    n = 32
    vals = _values(half, n)
    tws = _values(100 + half, half)
    x = fo.mont_words(fo.FR, vals, "cpu")
    tw = fo.mont_words(fo.FR, tws, "cpu")
    pn.butterfly(x, tw, half)
    got = fo.from_mont_words(fo.FR, x)
    want = list(vals)
    for b in range(0, n, 2 * half):
        for j in range(half):
            u, v = vals[b + j], vals[b + half + j] * tws[j] % ff.R
            want[b + j] = (u + v) % ff.R
            want[b + half + j] = (u - v) % ff.R
    assert got == want


def test_scale_twin():
    vals = _values(7, 16)
    x = fo.mont_words(fo.FR, vals, "cpu")
    c = 1234567
    out = pn.scale(x, fo.ints_to_words([fo.FR.to_mont_int(c)])[0])
    assert fo.from_mont_words(fo.FR, out) == [v * c % ff.R for v in vals]
    pn.scale(x, fo.ints_to_words([fo.FR.to_mont_int(c)])[0], out=x)
    assert torch.equal(x, out)


def test_wrappers_refuse_bad_shapes():
    x = torch.zeros((16, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        pn.butterfly(x, torch.zeros((3, 8), dtype=torch.int32), 3)
    with pytest.raises(ValueError):
        pn.butterfly(x, torch.zeros((4, 8), dtype=torch.int64), 4)
    with pytest.raises(ValueError):
        pn.ntt_auto(x, 5)
    with pytest.raises(ValueError):
        pn.scale(x[:, :4], np.zeros(8, np.uint32))
