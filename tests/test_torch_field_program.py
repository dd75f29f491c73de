"""The row program (ops/field `RowProgram`, `run_program`) and its compiler
(prover/quotient_program.py) on the CPU, where `run_program` runs its plain
twin `run_program_plain`:

  * a hand-made expression over four columns (negation, scaling, constants,
    challenges, rotations -1, 0, +1 and -(bf + 1)) equals its per-row
    evaluation with the JAX package's ff/bn254 integers;
  * the compiled quotient program of the zkevm-shape circuit (k = 7, two
    proofs) on random extended columns equals the eager fold of
    `Expression.evaluate` over whole columns that the prover ran before the
    row program, kept here as the oracle;
  * the opening's fold and the permutation's grand-product factors,
    compiled, equal their per-row evaluation with integers;
  * a program over the slot limit raises, and malformed programs are
    refused;
  * the slot limit and the transform's pass limit agree with csrc/.
"""

import re

import numpy as np
import pytest
import torch

from halo2_snark_aggregator_tpu.ff import bn254 as ff
from halo2_snark_aggregator_tpu_torch.circuits import zkevm as pzkevm
from halo2_snark_aggregator_tpu_torch.kernels import build
from halo2_snark_aggregator_tpu_torch.ops import field as fo
from halo2_snark_aggregator_tpu_torch.ops import ntt as pn
from halo2_snark_aggregator_tpu_torch.protocol.plonk import (ConstraintSystem,
                                                             Expression)
from halo2_snark_aggregator_tpu_torch.prover import accel
from halo2_snark_aggregator_tpu_torch.prover import quotient_program as qp

FR_DELTA = ff.FR_DELTA


def _ints(rng, m: int) -> list[int]:
    return [int.from_bytes(rng.bytes(32), "little") % ff.R for _ in range(m)]


def _col(rng, n: int) -> torch.Tensor:
    return fo.mont_words(fo.FR, _ints(rng, n), "cpu")


def test_hand_made_expression_matches_ints():
    n, bf = 16, 3
    rng = np.random.default_rng(31)
    vals = [_ints(rng, n) for _ in range(4)]
    cols = [fo.mont_words(fo.FR, v, "cpu") for v in vals]
    challenges = _ints(rng, 2)
    # query index -> (column, rotation)
    queries = [(0, 0), (1, -1), (2, 1), (3, -(bf + 1)), (0, 1)]
    q = [Expression.advice(i) for i in range(len(queries))]
    expr = (q[0] * q[1] - q[2] * 5 + (-q[3]) * Expression.challenge(1)
            + 7 * q[4] * q[0] - Expression.const(3)
            + Expression.challenge(0) * (q[2] + q[3] * q[1]))

    b = qp.ProgramBuilder()
    prog, keys = b.finish(expr.evaluate(
        constant=b.const, fixed=None,
        advice=lambda i: b.column(("c", queries[i][0]), queries[i][1]),
        instance=None, challenge=lambda i: b.const(challenges[i]),
        neg=b.neg, add=b.add, mul=b.mul,
        scale=lambda a, s: b.mul(a, b.const(s))))
    got = fo.from_mont_words(fo.FR, fo.run_program(
        prog, [cols[key[1]] for key in keys]))

    def row(i):
        return expr.evaluate(
            constant=lambda v: v, fixed=None,
            advice=lambda j: vals[queries[j][0]][(i + queries[j][1]) % n],
            instance=None, challenge=lambda j: challenges[j],
            neg=lambda a: -a % ff.R, add=lambda a, c: (a + c) % ff.R,
            mul=lambda a, c: a * c % ff.R, scale=lambda a, s: a * s % ff.R)

    assert got == [row(i) for i in range(n)]
    assert sorted(keys) == [("c", j) for j in range(4)]


def _eager_fold(cs, num_proofs, challenges, theta, beta, gamma, y, ext):
    """The quotient numerator on one shard as the prover computed it
    before the row program: whole-column field ops (the plain twins on the
    CPU), a rotation a `torch.roll`; `ext(key)` is the extended column."""
    n = ext(("l0",)).shape[0]
    bf = cs.blinding_factors()
    chunk_len = cs.permutation_chunk_len()
    n_sets = -(-len(cs.permutation_columns) // chunk_len)

    def scalar(v):
        return accel._bcast(accel.mont_scalar(v, "cpu"), n)

    def roll(arr, rot):
        return torch.roll(arr, -rot, dims=0) if rot else arr

    m_mul, m_add, m_sub = accel.m_mul, accel.m_add, accel.m_sub
    y_b, theta_b, beta_b = scalar(y), scalar(theta), scalar(beta)
    gamma_b, one_b = scalar(gamma), scalar(1)
    l0_e, ll_e = ext(("l0",)), ext(("l_last",))
    active = m_sub(one_b, m_add(ll_e, ext(("l_blind",))))
    acc = torch.zeros((n, 8), dtype=torch.int32)

    def fold(e):
        nonlocal acc
        acc = m_add(m_mul(acc, y_b), e)

    for p in range(num_proofs):
        def expr_ext(e):
            return e.evaluate(
                constant=scalar,
                fixed=lambda q: roll(ext(("fixed", cs.fixed_queries[q][0])),
                                     cs.fixed_queries[q][1]),
                advice=lambda q: roll(ext(("advice", p, cs.advice_queries[q][0])),
                                      cs.advice_queries[q][1]),
                instance=lambda q: roll(
                    ext(("instance", p, cs.instance_queries[q][0])),
                    cs.instance_queries[q][1]),
                challenge=lambda i: scalar(challenges[i]),
                neg=lambda a: m_sub(torch.zeros_like(a), a),
                add=m_add, mul=m_mul, scale=lambda a, sc: m_mul(a, scalar(sc)))

        for _, polys in cs.gates:
            for g in polys:
                fold(expr_ext(g))
        sets_e = [ext(("perm_z", p, s)) for s in range(n_sets)]
        fold(m_mul(l0_e, m_sub(one_b, sets_e[0])))
        zl = sets_e[-1]
        fold(m_mul(ll_e, m_sub(m_mul(zl, zl), zl)))
        for s_idx in range(1, len(sets_e)):
            prev_rot = roll(sets_e[s_idx - 1], -(bf + 1))
            fold(m_mul(m_sub(sets_e[s_idx], prev_rot), l0_e))
        omega_do = ext(("x",))
        for chunk_idx0, start in enumerate(range(0, len(cs.permutation_columns),
                                                 chunk_len)):
            chunk = cs.permutation_columns[start : start + chunk_len]
            zc_e = sets_e[chunk_idx0]
            left, right = roll(zc_e, 1), zc_e
            delta_pow = pow(FR_DELTA, chunk_idx0 * chunk_len, ff.R)
            for j, col in enumerate(chunk):
                qidx = cs.get_any_query_index(col, 0)
                if col.kind == "advice":
                    vp = ext(("advice", p, cs.advice_queries[qidx][0]))
                elif col.kind == "fixed":
                    vp = ext(("fixed", cs.fixed_queries[qidx][0]))
                else:
                    vp = ext(("instance", p, cs.instance_queries[qidx][0]))
                sigma_e = ext(("sigma", start + j))
                left = m_mul(left, m_add(vp, m_add(m_mul(beta_b, sigma_e), gamma_b)))
                dx = m_mul(omega_do, scalar(beta * delta_pow % ff.R))
                right = m_mul(right, m_add(vp, m_add(dx, gamma_b)))
                delta_pow = delta_pow * FR_DELTA % ff.R
            fold(m_mul(m_sub(left, right), active))
        for lk_idx, arg in enumerate(cs.lookups):
            zc_e = ext(("lookup_z", p, lk_idx))
            ac_e = ext(("lookup_a", p, lk_idx))
            sc_e = ext(("lookup_s", p, lk_idx))
            z_next, a_prev = roll(zc_e, 1), roll(ac_e, -1)
            input_e = torch.zeros((n, 8), dtype=torch.int32)
            for e in arg.input_expressions:
                input_e = m_add(m_mul(input_e, theta_b), expr_ext(e))
            table_e = torch.zeros((n, 8), dtype=torch.int32)
            for e in arg.table_expressions:
                table_e = m_add(m_mul(table_e, theta_b), expr_ext(e))
            fold(m_mul(l0_e, m_sub(one_b, zc_e)))
            fold(m_mul(ll_e, m_sub(m_mul(zc_e, zc_e), zc_e)))
            left = m_mul(z_next, m_mul(m_add(ac_e, beta_b), m_add(sc_e, gamma_b)))
            right = m_mul(zc_e, m_mul(m_add(input_e, beta_b), m_add(table_e, gamma_b)))
            fold(m_mul(m_sub(left, right), active))
            a_minus_s = m_sub(ac_e, sc_e)
            fold(m_mul(l0_e, a_minus_s))
            fold(m_mul(m_mul(a_minus_s, m_sub(ac_e, a_prev)), active))
    return acc


def test_zkevm_quotient_program_matches_eager_fold():
    k, num_proofs = 7, 2
    n = 1 << k
    cs = ConstraintSystem()
    pzkevm.ZkevmShapeCircuit(k=k, seed=3, n_groups=2, table_bits=6).configure(cs)
    rng = np.random.default_rng(32)
    challenges = _ints(rng, cs.num_challenges)
    theta, beta, gamma, y = _ints(rng, 4)
    prog, keys = qp.compile_quotient(cs, num_proofs, challenges, theta, beta,
                                     gamma, y)
    cols = {key: _col(rng, n) for key in keys}
    got = fo.run_program(prog, [cols[key] for key in keys])
    want = _eager_fold(cs, num_proofs, challenges, theta, beta, gamma, y,
                       lambda key: cols[key])
    assert torch.equal(got, want)
    assert len(keys) == len(set(keys))
    assert prog.n_slots <= fo.PROGRAM_SLOTS
    assert prog.products > 100


def test_fold_and_perm_products_match_ints():
    n = 8
    rng = np.random.default_rng(34)
    vals = [_ints(rng, n) for _ in range(3)]
    cols = [fo.mont_words(fo.FR, v, "cpu") for v in vals]
    v = _ints(rng, 1)[0]
    got = fo.from_mont_words(fo.FR, fo.run_program(qp.compile_fold(3, v), cols))
    assert got == [(vals[0][i] * v * v + vals[1][i] * v + vals[2][i]) % ff.R
                   for i in range(n)]

    beta, gamma, *deltas = _ints(rng, 4)
    omega = _ints(rng, n)
    sig = [_ints(rng, n) for _ in range(2)]
    named = {("omega",): omega, ("v", 0): vals[0], ("v", 1): vals[1],
             ("sigma", 0): sig[0], ("sigma", 1): sig[1]}
    (num, num_keys), (den, den_keys) = qp.compile_perm_products(deltas[:2],
                                                                beta, gamma)
    for prog, keys, term in (
            (num, num_keys, lambda j, i: deltas[j] * omega[i]),
            (den, den_keys, lambda j, i: sig[j][i])):
        out = fo.run_program(prog, [fo.mont_words(fo.FR, named[key], "cpu")
                                    for key in keys])
        want = [(vals[0][i] + beta * term(0, i) + gamma)
                * (vals[1][i] + beta * term(1, i) + gamma) % ff.R
                for i in range(n)]
        assert fo.from_mont_words(fo.FR, out) == want


def test_program_over_slot_limit_raises():
    b = qp.ProgramBuilder()
    live = [b.mul(b.column(("c", i)), b.column(("c", i), 1)) for i in range(6)]
    out = live[0]
    for v in live[1:]:
        out = b.add(out, v)
    with pytest.raises(ValueError, match="more than 5 slots"):
        b.finish(out, max_slots=5)
    prog, _ = b.finish(out, max_slots=6)
    assert prog.n_slots == 6
    with pytest.raises(ValueError):
        b.finish(out, max_slots=fo.PROGRAM_SLOTS + 1)


def test_slots_are_reused_by_liveness():
    """A chain keeps two values live however long it is; a result may take
    the slot of the operand it reads last."""
    rng = np.random.default_rng(33)
    n = 8
    cols = [_col(rng, n) for _ in range(3)]
    b = qp.ProgramBuilder()
    acc = b.column(("c", 0))
    for i in range(40):
        acc = b.add(b.mul(acc, b.column(("c", 1 + i % 2))), b.const(i))
    prog, keys = b.finish(acc)
    assert prog.n_slots == 1
    got = fo.from_mont_words(fo.FR, fo.run_program(prog, [cols[key[1]] for key in keys]))
    vals = [fo.from_mont_words(fo.FR, c) for c in cols]
    want = list(vals[0])
    for i in range(40):
        want = [(w * vals[1 + i % 2][r] + i) % ff.R for r, w in enumerate(want)]
    assert got == want


def test_malformed_programs_are_refused():
    one = fo.ints_to_words([fo.FR.r_mont])
    col = fo.operand(fo.COLUMN, 0)
    ok = dict(code=[(fo.MUL, 0, col, col)], refs=[(0, 0)], consts=one,
              n_cols=1, out=fo.operand(fo.SLOT, 0))
    fo.RowProgram(**ok)
    for bad in (dict(code=[(fo.POW, 0, col, col)]),
                dict(code=[(fo.MUL, fo.PROGRAM_SLOTS, col, col)]),
                dict(refs=[(1, 0)]),
                dict(code=[(fo.MUL, 0, fo.operand(fo.CONST, 1), col)]),
                dict(out=fo.operand(3, 0))):
        with pytest.raises(ValueError):
            fo.RowProgram(**{**ok, **bad})
    prog = fo.RowProgram(**ok)
    with pytest.raises(ValueError):
        fo.run_program(prog, [])
    with pytest.raises(ValueError):
        fo.run_program(prog, [torch.zeros((6, 8), dtype=torch.int32)])
    with pytest.raises(ValueError):
        qp.ProgramBuilder().roll(qp.ProgramBuilder().const(1), 1)


def test_limits_agree_with_csrc():
    field_cu = (build.CSRC / "field.cu").read_text()
    ntt_cu = (build.CSRC / "ntt.cu").read_text()
    assert int(re.search(r"kProgSlots = (\d+);", field_cu).group(1)) == fo.PROGRAM_SLOTS
    tile = int(re.search(r"kNttTileRows = (\d+);", ntt_cu).group(1))
    assert tile == 1 << pn.PASS_STAGES
    assert f"m > {pn.PASS_STAGES}" in ntt_cu
    assert f"k > {pn.MAX_K}" in ntt_cu
    assert f"b > {pn.MAX_BATCH}" in ntt_cu
