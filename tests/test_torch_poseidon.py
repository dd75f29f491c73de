"""The port's Poseidon (ops/poseidon.py) against the reference: the plain
twin against `poseidon_spec.permute_py` and the native permutation, the
sponge call (a one-call table through `sponge_chain`) against the host
absorb rule, a chain of calls against the host sponge, and the tables
against the Pallas kernel's constants. Exact equality throughout."""

import numpy as np
import pytest
import torch

from halo2_snark_aggregator_tpu import native
from halo2_snark_aggregator_tpu.ff import bn254 as ff
from halo2_snark_aggregator_tpu.hashes import poseidon_spec as pspec
from halo2_snark_aggregator_tpu.ops import poseidon_pallas
from halo2_snark_aggregator_tpu_torch import convert
from halo2_snark_aggregator_tpu_torch.hashes import poseidon_host
from halo2_snark_aggregator_tpu_torch.ops import field as fo
from halo2_snark_aggregator_tpu_torch.ops import poseidon as po


def _states(seed, n):
    rng = np.random.default_rng(seed)
    return [[int.from_bytes(rng.bytes(32), "little") % ff.R for _ in range(9)]
            for _ in range(n)]


def _sponge_call(slots, st_idx, in_idx, n_in, pad_pos, out_idx):
    """One sponge call over every lane of `slots`, in place: a one-row call
    table through the wrapper `sponge_chain`. in_idx may be None or shorter
    than 8 (entries past n_in are unread)."""
    ins = np.zeros(pspec.RATE, np.int64)
    if in_idx is not None:
        ins[: len(in_idx)] = in_idx
    chain = po.chain_table([st_idx], [ins], [n_in], [pad_pos], [out_idx], "cpu")
    po.sponge_chain(slots, chain)


def _permute(states: torch.Tensor) -> torch.Tensor:
    """Permute a batch of states (n, 9, 8) through one sponge call with no
    inputs and no pad marker."""
    buf = states.transpose(0, 1).contiguous()
    idx = range(pspec.T)
    _sponge_call(buf, idx, None, 0, -1, idx)
    return buf.transpose(0, 1).contiguous()


def test_permute_matches_spec_and_native():
    states = _states(21, 3) + [[0] * 9]
    x = fo.mont_words(fo.FR, [v for s in states for v in s], "cpu").reshape(-1, 9, 8)
    got = fo.from_mont_words(fo.FR, _permute(x))
    want = [v for s in states for v in pspec.permute_py(s)]
    assert got == want
    if native.available():
        assert want == [v for s in states for v in native.poseidon_permute(s)]


@pytest.mark.parametrize("n_in", [0, 3, 8])
def test_sponge_call_matches_host_absorb(n_in):
    """Gather state + inputs by row, add inputs into state[1..] and the pad
    marker at state[1 + n_in] (when n_in < RATE), permute, scatter."""
    rng = np.random.default_rng(22 + n_in)
    rows, lanes = 30, 2
    vals = [int.from_bytes(rng.bytes(32), "little") % ff.R for _ in range(rows * lanes)]
    slots = fo.mont_words(fo.FR, vals, "cpu").reshape(rows, lanes, 8)
    st = rng.permutation(12)[:9]
    ins = 12 + rng.permutation(8)[:max(n_in, 1)]
    out = 20 + rng.permutation(10)[:9]
    pad = 1 + n_in if n_in < pspec.RATE else -1
    _sponge_call(slots, st, ins, n_in, pad, out)
    got = np.array(fo.from_mont_words(fo.FR, slots), dtype=object).reshape(rows, lanes)
    v = np.array(vals, dtype=object).reshape(rows, lanes)
    for lane in range(lanes):
        s = [v[r, lane] for r in st]
        for i in range(n_in):
            s[1 + i] = (s[1 + i] + v[ins[i], lane]) % ff.R
        if pad >= 0:
            s[pad] = (s[pad] + 1) % ff.R
        assert [got[r, lane] for r in out] == pspec.permute_py(s)
    untouched = [r for r in range(rows) if r not in set(out.tolist())]
    assert all(list(got[r]) == list(v[r]) for r in untouched)


def test_tables_match_pallas_constants():
    rc_pallas, mds_ints = poseidon_pallas._kernel_constants()
    rc_w, mds_w = po.table_words()
    assert np.array_equal(rc_w, convert.poseidon_rc_from_pallas(rc_pallas))
    mds16 = np.array(mds_ints, dtype=np.uint32)  # (9, 9, 16)
    assert np.array_equal(mds_w, convert.words_from_canonical16(mds16))
    assert rc_w.shape == (pspec.R_F + pspec.R_P, pspec.T, 8)


def test_sponge_call_validates():
    slots = torch.zeros((20, 2, 8), dtype=torch.int32)
    idx = list(range(9))
    with pytest.raises(ValueError):
        _sponge_call(slots, idx[:5], None, 0, -1, idx)
    with pytest.raises(ValueError):
        _sponge_call(slots, idx, None, 9, -1, idx)
    with pytest.raises(ValueError):
        _sponge_call(slots.long(), idx, None, 0, -1, idx)


def test_sponge_chain_matches_host_sponge():
    """Three chained calls over 4 lanes: absorb 12 values from the zero
    state (8 inputs; then 4 inputs and the pad marker, reading the first
    call's output) and squeeze again (no input, pad at 1, in place). The
    state equals the port's host sponge and a replay through the JAX
    package's `poseidon_spec`."""
    rng = np.random.default_rng(23)
    lanes, rows = 4, 39
    vals = [[int.from_bytes(rng.bytes(32), "little") % ff.R for _ in range(12)]
            for _ in range(lanes)]
    slot_vals = np.zeros((rows, lanes), dtype=object)
    for lane in range(lanes):
        slot_vals[9:21, lane] = vals[lane]
    slots = fo.mont_words(fo.FR, slot_vals.ravel().tolist(), "cpu").reshape(rows, lanes, 8)
    zero, first, second = range(9), range(21, 30), range(30, 39)
    ins = np.zeros((3, pspec.RATE), np.int64)
    ins[0] = range(9, 17)
    ins[1, :4] = range(17, 21)
    chain = po.chain_table([zero, first, second], ins, [8, 4, 0], [-1, 5, 1],
                           [first, second, second], "cpu")
    po.sponge_chain_plain(slots, chain)
    got = fo.from_mont_words(fo.FR, slots[30:39].transpose(0, 1))
    for lane in range(lanes):
        sponge = poseidon_host.PoseidonSponge()
        sponge.update(vals[lane])
        sponge.squeeze()
        sponge.squeeze()
        state = [0] * 9
        for chunk, pad in ((vals[lane][:8], None), (vals[lane][8:], 5), ([], 1)):
            state = [(v + (chunk[i - 1] if 1 <= i <= len(chunk) else 0)
                      + (i == pad)) % ff.R for i, v in enumerate(state)]
            state = pspec.permute_py(state)
        assert got[9 * lane : 9 * lane + 9] == sponge.state == state


def test_sponge_chain_wrapper_is_one_chain():
    """The wrapper runs the table's calls in order (its CPU path): a
    two-call table equals two one-call tables in turn."""
    rng = np.random.default_rng(24)
    vals = [int.from_bytes(rng.bytes(32), "little") % ff.R for _ in range(20 * 3)]
    slots = fo.mont_words(fo.FR, vals, "cpu").reshape(20, 3, 8)
    ins = np.zeros((2, pspec.RATE), np.int64)
    ins[0, :2] = [9, 10]
    chain = po.chain_table([range(9), range(11, 20)], ins, [2, 0], [3, -1],
                           [range(11, 20), range(11, 20)], "cpu")
    a, b = slots.clone(), slots.clone()
    po.sponge_chain(a, chain)
    _sponge_call(b, range(9), [9, 10], 2, 3, range(11, 20))
    _sponge_call(b, range(11, 20), None, 0, -1, range(11, 20))
    assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["shape", "n_in", "pad", "row"])
def test_chain_table_validates(bad):
    st, ins, n_in, pad, out = [range(9)], np.zeros((1, 8)), [8], [-1], [range(9)]
    if bad == "shape":
        ins = np.zeros((1, 7))
    elif bad == "n_in":
        n_in = [9]
    elif bad == "pad":
        pad = [9]
    else:
        st = [[-1] + list(range(8))]
    with pytest.raises(ValueError):
        po.chain_table(st, ins, n_in, pad, out, "cpu")
