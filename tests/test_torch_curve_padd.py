"""The port's batched complete add (ops/curve.padd) and fixed-base sum
(ops/curve.fixed_base) on the CPU, where they run their plain twins,
against the reference. The add: the JAX package's `ops/curve_rr.add`
(RCB15 Algorithm 7 over redundant limbs, the formula its Pallas padd
kernel transcribes) word for word on the projective result, and the host
`ff.g1_add` on the affine result; one batch holds random pairs, the
identity on either side and on both, doublings P + P and inverses P +
(-P). The fixed-base sum, on groups of scalars (edge values, sparse
digits, random): the host `ff.g1_mul` on the affine result, and the padd
tree over the same digit points (the sum the JAX package's
prover/srs.fixed_base_msm makes) after normalisation, word for word; the reference's own jitted fixed_base_msm
takes ~46 s on the CPU for 8 scalars, so the accelerated setup at k = 3 is
held to the reference's host `ParamsKZG.unsafe_setup` instead. Exact
equality."""

import functools

import jax
import numpy as np
import pytest
import torch

from halo2_snark_aggregator_tpu.ff import bn254 as ff
from halo2_snark_aggregator_tpu.ops import curve_rr
from halo2_snark_aggregator_tpu.prover.kzg import ParamsKZG
from halo2_snark_aggregator_tpu_torch import convert
from halo2_snark_aggregator_tpu_torch.ops import curve as cv
from halo2_snark_aggregator_tpu_torch.ops import field as fo
from halo2_snark_aggregator_tpu_torch.prover import srs


def _pairs(seed: int, n: int):
    rng = np.random.default_rng(seed)
    pts = [ff.g1_mul(ff.G1_GEN, int(rng.integers(1, 1 << 62)))
           for _ in range(n)]
    a = list(pts) + [None, pts[0], None, pts[1], pts[2]]
    b = pts[::-1] + [pts[3], None, None, pts[1], ff.g1_neg(pts[2])]
    return a, b


def _batch(points) -> torch.Tensor:
    return torch.stack(cv.from_affine_ints(points, "cpu"), dim=1)


def test_padd_matches_reference_and_host():
    a, b = _pairs(3, 11)
    got = cv.padd(_batch(a), _batch(b))
    assert got.shape == (len(a), 3, 8)
    # host: affine sums
    assert cv.to_affine_ints(got.unbind(1)) == [ff.g1_add(p, q)
                                                for p, q in zip(a, b)]
    # reference: projective coordinates, word for word
    want = jax.jit(curve_rr.add)(curve_rr.from_affine_ints(a),
                                 curve_rr.from_affine_ints(b))
    for i, coord in enumerate(want):
        np.testing.assert_array_equal(
            fo.to_numpy(got[:, i]),
            convert.words_from_rr(np.asarray(coord.limbs), ff.P))


def test_padd_on_projective_inputs():
    """Inputs with z != 1 (the SRS tree's later levels): the sum of sums
    equals the host sum."""
    a, b = _pairs(5, 6)
    ab = cv.padd(_batch(a), _batch(b))
    ba = cv.padd(_batch(b), _batch(a))
    total = cv.padd(ab, ba)
    want = [ff.g1_add(ff.g1_add(p, q), ff.g1_add(q, p)) for p, q in zip(a, b)]
    assert cv.to_affine_ints(total.unbind(1)) == want


def test_normalize_affine():
    a, b = _pairs(9, 5)
    proj = cv.padd(_batch(a), _batch(b))
    aff = cv.normalize_affine(proj)
    sums = [ff.g1_add(p, q) for p, q in zip(a, b)]
    assert torch.equal(aff, _batch(sums))


def test_padd_refuses_bad_inputs():
    x = torch.zeros((4, 3, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        cv.padd(x, x[:3])
    with pytest.raises(ValueError):
        cv.padd(x, x.to(torch.int64))
    with pytest.raises(ValueError):
        cv.padd(x.transpose(0, 1), x.transpose(0, 1))


# -- the fixed-base sum --------------------------------------------------------

_SCALARS = {
    "edges": [0, 1, ff.R - 1, (1 << 256) - 1],       # the last: 32 digits 0xff
    "sparse": [(0x01 << 248) | (0x0203 << 120) | 0x04,  # zero digits inside
               0xFF << 128, 1 << 255],                # one nonzero digit
    "random": [int.from_bytes(np.random.default_rng(s).bytes(32), "little")
               % ff.R for s in range(3)],
}


@functools.lru_cache(maxsize=1)
def _table() -> torch.Tensor:
    return srs.g1_table("cpu")


def _scalar_words(group: str) -> torch.Tensor:
    return fo.to_tensor(fo.ints_to_words(_SCALARS[group]), "cpu")


@pytest.mark.parametrize("group", sorted(_SCALARS))
def test_fixed_base_twin_matches_host_and_tree(group):
    sw, table = _scalar_words(group), _table()
    out = cv.fixed_base_plain(sw, table)
    assert out.shape == (len(_SCALARS[group]), 3, 8)
    assert cv.to_affine_ints(out.unbind(1)) == [
        ff.g1_mul(ff.G1_GEN, s) if s % ff.R else None for s in _SCALARS[group]]
    tree = cv.padd_tree(cv.digit_points(sw, table))
    assert torch.equal(cv.normalize_affine(out), cv.normalize_affine(tree))
    assert torch.equal(cv.fixed_base(sw, table), out)


def test_fixed_base_refuses_bad_inputs():
    sw, table = _scalar_words("edges"), _table()
    with pytest.raises(ValueError):
        cv.fixed_base(sw.to(torch.int64), table)
    with pytest.raises(ValueError):
        cv.fixed_base(sw[:, :4], table)
    with pytest.raises(ValueError):
        cv.fixed_base(sw, table[:-1])
    with pytest.raises(ValueError):
        cv.fixed_base_plain(sw.t().contiguous(), table)


def test_unsafe_setup_accel_matches_reference_k3():
    """The accelerated setup (one fixed-base launch, then affine
    normalisation) gives the reference host setup's points."""
    k = 3
    params = srs.unsafe_setup_accel(k, device="cpu")
    ref = ParamsKZG.unsafe_setup(k)
    assert cv.to_affine_ints(params.g_dev.unbind(1)) == ref.g
    z = params.g_dev[:, 2]
    assert torch.equal(z, fo.const(fo.FQ, 1, "cpu").expand_as(z))
    assert params.g_lagrange == ref.g_lagrange
    for got, want in ((params.g2, ref.g2), (params.s_g2, ref.s_g2)):
        assert [(c.c0, c.c1) for c in got] == [(c.c0, c.c1) for c in want]


@pytest.mark.parametrize("k", [1, 5, 9])
def test_tau_powers_words_match_host_list(k):
    """The SRS's scalars built by doubling through the field kernel (its twin
    here) equal the host list `tau_powers`, in standard form."""
    got = srs.tau_powers_words(k, "cpu")
    assert got.shape == (1 << k, 8) and got.dtype == torch.int32
    assert fo.words_to_ints(got) == srs.tau_powers(k)
