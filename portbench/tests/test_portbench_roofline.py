"""The roofline's work counts at the cells' shapes."""

import random

import numpy as np
import pytest

from portbench import roofline
from portbench.reference import bn254 as ff
from portbench.reference import poseidon_spec


def test_poseidon_products_from_the_spec():
    assert (poseidon_spec.T, poseidon_spec.R_F, poseidon_spec.R_P) == (
        roofline.POSEIDON_T, roofline.POSEIDON_R_F, roofline.POSEIDON_R_P)
    # 8 full rounds: 9 S-boxes (3 products) + 81 dense MDS products; 63
    # partial rounds: one S-box + a sparse matrix's 2t - 1 = 17
    assert roofline.poseidon_products() == 8 * (27 + 81) + 63 * (3 + 17) == 2124


@pytest.mark.parametrize("calls,lanes", [(30, 128), (106, 128), (30, 8)])
def test_poseidon_chain_bound_is_operations(calls, lanes):
    perms = calls * lanes
    want = perms * 2124 * 264 / (132 * 64 * 1980e6)
    assert roofline.poseidon_chain_seconds(perms) == pytest.approx(want)


def test_accumulate_bound_matches_the_bring_up_table():
    # 2^16 points, c = 8: 2,087,263 mixed adds, bound 0.362 ms (operations)
    assert roofline.accumulate_seconds(2_087_263) * 1e3 == pytest.approx(0.3624,
                                                                        abs=1e-4)


def test_share_needs_a_measurement():
    assert roofline.share(1.0, 0.0) is None
    assert roofline.share(0.0, 1.0) is None
    assert roofline.share(0.5, 2.0) == pytest.approx(25.0)


def _mont_words(vals):
    buf = b"".join((v * (1 << 256) % ff.R).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u4").reshape(len(vals), 8).view(np.int32)


def test_nonzero_digits_count_the_standard_form():
    rng = random.Random(5)
    vals = [rng.randrange(ff.R) for _ in range(300)] + [0, 1, 255, 256, 2**64]
    want = sum(1 for v in vals for j in range(32) if (v >> (8 * j)) & 255)
    assert roofline.nonzero_digits(_mont_words(vals)) == want
    # small values: one digit each, though their Montgomery words are full
    assert roofline.nonzero_digits(_mont_words([1, 2, 3, 0])) == 3
    assert roofline.nonzero_digits(_mont_words([0x0102, 0x010000]), c=4) == 3
