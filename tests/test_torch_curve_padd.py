"""The port's batched complete add (ops/curve.padd) on the CPU, where it runs
its plain twin, against the reference: the JAX package's
`ops/curve_rr.add` (RCB15 Algorithm 7 over redundant limbs, the formula
its Pallas padd kernel transcribes) word for word on the projective
result, and the host `ff.g1_add` on the affine result. One batch holds
random pairs, the identity on either side and on both, doublings P + P
and inverses P + (-P). Exact equality."""

import jax
import numpy as np
import pytest
import torch

from halo2_snark_aggregator_tpu.ff import bn254 as ff
from halo2_snark_aggregator_tpu.ops import curve_rr
from halo2_snark_aggregator_tpu_torch import convert
from halo2_snark_aggregator_tpu_torch.ops import curve as cv
from halo2_snark_aggregator_tpu_torch.ops import field as fo


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
