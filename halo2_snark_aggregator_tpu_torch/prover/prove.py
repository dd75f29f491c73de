# Copy of halo2_snark_aggregator_tpu/prover/prove.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""halo2-compatible PLONK prover (KZG / GWC multiopen).

The environment ships no Rust toolchain, so reference proofs cannot be
generated from /root/reference; this prover produces proofs in exactly the
transcript layout the reference verifier replays (verify.rs:342-571), making
it both the fixture generator for the verifier tests and the base for the
TPU-accelerated prover (NTT/MSM offload).

Transcript write order (must mirror build_params read order, verify.rs:342-483):
  vk digest (absorbed) | instance commitments (absorbed) |
  advice commitments per phase + phase challenges | theta |
  lookup permuted (A', S') | beta gamma | permutation z | lookup z |
  vanishing random | y | h pieces | x | instance evals | advice evals |
  fixed evals | random eval | sigma evals | permutation set evals |
  lookup evals | v | W per rotation set | (u squeezed by verifier)
"""

from __future__ import annotations

import random as _random

from ..ff import bn254 as ff
from ..ff.bn254 import FR_DELTA, R
from ..protocol.plonk import Expression, VerifyingKey
from ..protocol.queryplan import query_plan, rotation_sets
from .domain import (
    Domain,
    kate_division,
    poly_add,
    poly_divide_vanishing,
    poly_eval,
    poly_mul,
    poly_rotate,
    poly_scale,
)
from .keygen import Assignment, ProvingKey
from .kzg import ParamsKZG


def _lagrange_basis_poly(domain: Domain, row: int) -> list[int]:
    e = [0] * domain.n
    e[row] = 1
    return domain.lagrange_to_coeff(e)


def create_proof(
    pk: ProvingKey,
    params: ParamsKZG,
    circuits: list,
    instances_per_proof: list[list[list[int]]],
    transcript,
    seed: int = 0,
) -> bytes:
    """Prove `num_proofs` circuit instances into a single transcript.

    circuits: one Circuit object (carrying its witness) per proof.
    instances_per_proof: [proof][instance_column][row] public values.
    `transcript` is a PoseidonWrite/ShaWrite-style writer.
    Returns the proof bytes.
    """
    from ..protocol.plonk import ConstraintSystem as _CS
    vk: VerifyingKey = pk.vk
    cs = vk.cs
    domain = pk.domain
    n = domain.n
    bf = cs.blinding_factors()
    usable = n - (bf + 1)
    num_proofs = len(instances_per_proof)
    rng = _random.Random(seed)

    def rand_fr() -> int:
        return rng.randrange(R)

    # -- 0. vk digest ------------------------------------------------------
    transcript.common_scalar(vk.transcript_repr())

    # -- 1. instances ------------------------------------------------------
    instance_lagrange = []  # [proof][col][n]
    instance_coeff = []
    for insts in instances_per_proof:
        assert len(insts) == cs.num_instance_columns
        cols_l, cols_c = [], []
        for vals in insts:
            assert len(vals) <= usable
            col = [v % R for v in vals] + [0] * (n - len(vals))
            cols_l.append(col)
            cols_c.append(domain.lagrange_to_coeff(col))
            transcript.common_point(params.commit_lagrange(list(vals)))
        instance_lagrange.append(cols_l)
        instance_coeff.append(cols_c)

    # -- 2. advice: per-phase synthesis -> blind -> commit -> challenges ---
    # (halo2 re-synthesizes each phase so phase>0 witnesses can consume the
    # challenges squeezed so far; single-phase circuits synthesize once and
    # keep the historical RNG call order byte-for-byte)
    advice_lagrange = [[None] * cs.num_advice_columns for _ in range(num_proofs)]
    assert len(circuits) == num_proofs
    challenges: dict[int, int] = {}
    for phase in cs.phases():
        for p in range(num_proofs):
            # configure() is deterministic; a throwaway CS yields identical
            # column handles to the keygen-time configuration.
            config = circuits[p].configure(_CS())
            assignment = Assignment(cs, n, usable, instances_per_proof[p],
                                    challenges=challenges)
            circuits[p].synthesize(config, assignment)
            for col_idx, col_phase in enumerate(cs.advice_column_phase):
                if col_phase == phase:
                    col = list(assignment.advice[col_idx])
                    for r in range(usable, n):
                        col[r] = rand_fr()
                    advice_lagrange[p][col_idx] = col
                    transcript.write_point(params.commit_lagrange(col))
        for ch_idx, ch_phase in enumerate(cs.challenge_phase):
            if ch_phase == phase:
                challenges[ch_idx] = transcript.squeeze_challenge()
    challenge_list = [challenges.get(i, 0) for i in range(cs.num_challenges)]

    advice_coeff = [
        [domain.lagrange_to_coeff(c) for c in cols] for cols in advice_lagrange
    ]

    theta = transcript.squeeze_challenge()

    # -- 3. lookups: permuted pairs ---------------------------------------
    def eval_expr_rows(expr: Expression, p: int) -> list[int]:
        """Evaluate an expression over all n rows (lagrange values)."""
        return expr.evaluate(
            constant=lambda v: [v] * n,
            fixed=lambda q: _rotated_rows(pk.fixed_lagrange[cs.fixed_queries[q][0]], cs.fixed_queries[q][1]),
            advice=lambda q: _rotated_rows(advice_lagrange[p][cs.advice_queries[q][0]], cs.advice_queries[q][1]),
            instance=lambda q: _rotated_rows(instance_lagrange[p][cs.instance_queries[q][0]], cs.instance_queries[q][1]),
            challenge=lambda i: [challenge_list[i]] * n,
            neg=lambda a: [(-x) % R for x in a],
            add=lambda a, b: [(x + y) % R for x, y in zip(a, b)],
            mul=lambda a, b: [x * y % R for x, y in zip(a, b)],
            scale=lambda a, s: [x * s % R for x in a],
        )

    def _rotated_rows(col: list[int], rot: int) -> list[int]:
        if rot == 0:
            return col
        return [col[(i + rot) % n] for i in range(n)]

    def compress(exprs: list[Expression], p: int) -> list[int]:
        rowsets = [eval_expr_rows(e, p) for e in exprs]
        out = [0] * n
        for rows in rowsets:
            out = [(acc * theta + v) % R for acc, v in zip(out, rows)]
        return out

    lookups_data = []  # [proof][lookup] dict with a_rows, s_rows, a_perm, s_perm
    for p in range(num_proofs):
        per_proof = []
        for arg in cs.lookups:
            a_rows = compress(arg.input_expressions, p)
            s_rows = compress(arg.table_expressions, p)
            a_perm, s_perm = _permute_pair(a_rows[:usable], s_rows[:usable])
            a_perm = a_perm + [rand_fr() for _ in range(n - usable)]
            s_perm = s_perm + [rand_fr() for _ in range(n - usable)]
            per_proof.append(dict(a_rows=a_rows, s_rows=s_rows, a_perm=a_perm, s_perm=s_perm))
        lookups_data.append(per_proof)

    for p in range(num_proofs):
        for lk in lookups_data[p]:
            transcript.write_point(params.commit_lagrange(lk["a_perm"]))
            transcript.write_point(params.commit_lagrange(lk["s_perm"]))

    beta = transcript.squeeze_challenge()
    gamma = transcript.squeeze_challenge()

    # -- 4. permutation z polynomials -------------------------------------
    chunk_len = cs.permutation_chunk_len()
    perm_cols = cs.permutation_columns
    perm_z = []  # [proof][set][n]
    for p in range(num_proofs):
        def col_rows(col):
            if col.kind == "advice":
                return advice_lagrange[p][col.index]
            if col.kind == "fixed":
                return pk.fixed_lagrange[col.index]
            return instance_lagrange[p][col.index]

        # hoisted omega^i row coefficients + batch-inverted denominators
        omega_pows = [0] * usable
        w = 1
        for i in range(usable):
            omega_pows[i] = w
            w = w * domain.omega % R

        sets = []
        last_z = 1
        for chunk_idx in range(0, len(perm_cols), chunk_len):
            chunk = perm_cols[chunk_idx : chunk_idx + chunk_len]
            nums = [1] * usable
            dens = [1] * usable
            for j, col in enumerate(chunk):
                rows = col_rows(col)
                sigmas = pk.sigmas_lagrange[chunk_idx + j]
                dcoef = pow(FR_DELTA, chunk_idx + j, R) * beta % R
                for i in range(usable):
                    v = rows[i]
                    nums[i] = nums[i] * ((v + dcoef * omega_pows[i] + gamma) % R) % R
                    dens[i] = dens[i] * ((v + beta * sigmas[i] + gamma) % R) % R
            dinv = ff.fr_inv_batch(dens)
            z = [0] * n
            z[0] = last_z
            for i in range(usable):
                z[i + 1] = z[i] * nums[i] % R * dinv[i] % R
            last_z = z[usable]
            for i in range(usable + 1, n):
                z[i] = rand_fr()
            sets.append(z)
        perm_z.append(sets)

    for p in range(num_proofs):
        for z in perm_z[p]:
            transcript.write_point(params.commit_lagrange(z))

    # -- 5. lookup z polynomials ------------------------------------------
    for p in range(num_proofs):
        for lk in lookups_data[p]:
            dens = [
                (lk["a_perm"][i] + beta) * (lk["s_perm"][i] + gamma) % R
                for i in range(usable)
            ]
            dinv = ff.fr_inv_batch(dens)
            z = [0] * n
            z[0] = 1
            for i in range(usable):
                num = (lk["a_rows"][i] + beta) * (lk["s_rows"][i] + gamma) % R
                z[i + 1] = z[i] * num % R * dinv[i] % R
            for i in range(usable + 1, n):
                z[i] = rand_fr()
            lk["z"] = z
    for p in range(num_proofs):
        for lk in lookups_data[p]:
            transcript.write_point(params.commit_lagrange(lk["z"]))

    # -- 6. vanishing random poly -----------------------------------------
    random_poly = [rand_fr() for _ in range(n)]
    transcript.write_point(params.commit_coeff(random_poly))

    y = transcript.squeeze_challenge()

    # -- 7. quotient h ----------------------------------------------------
    h_poly = _compute_h(
        pk, params, num_proofs, advice_coeff, instance_coeff,
        lookups_data, perm_z, challenge_list, theta, beta, gamma, y,
    )
    qd = vk.quotient_poly_degree()
    h_pieces = [h_poly[i * n : (i + 1) * n] for i in range(qd)]
    h_pieces = [piece + [0] * 0 for piece in h_pieces]
    assert len(h_poly) <= qd * n, (len(h_poly), qd, n)
    for piece in h_pieces:
        transcript.write_point(params.commit_coeff(piece) if piece else None)

    x = transcript.squeeze_challenge()

    # -- 8. evaluations ----------------------------------------------------
    lookup_coeffs = []
    for p in range(num_proofs):
        per = []
        for lk in lookups_data[p]:
            per.append(
                dict(
                    z=domain.lagrange_to_coeff(lk["z"]),
                    a=domain.lagrange_to_coeff(lk["a_perm"]),
                    s=domain.lagrange_to_coeff(lk["s_perm"]),
                )
            )
        lookup_coeffs.append(per)
    perm_z_coeff = [[domain.lagrange_to_coeff(z) for z in sets] for sets in perm_z]

    def poly_for(ref: tuple) -> list[int]:
        kind = ref[0]
        if kind == "instance":
            return instance_coeff[ref[1]][ref[2]]
        if kind == "advice":
            return advice_coeff[ref[1]][ref[2]]
        if kind == "perm_z":
            return perm_z_coeff[ref[1]][ref[2]]
        if kind == "lookup_z":
            return lookup_coeffs[ref[1]][ref[2]]["z"]
        if kind == "lookup_a":
            return lookup_coeffs[ref[1]][ref[2]]["a"]
        if kind == "lookup_s":
            return lookup_coeffs[ref[1]][ref[2]]["s"]
        if kind == "fixed":
            return pk.fixed_coeff[ref[1]]
        if kind == "sigma":
            return pk.sigmas_coeff[ref[1]]
        if kind == "h":
            return h_folded
        if kind == "random":
            return random_poly
        raise KeyError(ref)

    xn = pow(x, n, R)
    h_folded = [0]
    for piece in reversed(h_pieces):
        h_folded = poly_add(poly_scale(h_folded, xn), piece)

    # instance evals
    for p in range(num_proofs):
        for (col, rot) in cs.instance_queries:
            transcript.write_scalar(poly_eval(instance_coeff[p][col], domain.rotate_omega(x, rot)))
    # advice evals
    for p in range(num_proofs):
        for (col, rot) in cs.advice_queries:
            transcript.write_scalar(poly_eval(advice_coeff[p][col], domain.rotate_omega(x, rot)))
    # fixed evals
    for (col, rot) in cs.fixed_queries:
        transcript.write_scalar(poly_eval(pk.fixed_coeff[col], domain.rotate_omega(x, rot)))
    # random eval
    transcript.write_scalar(poly_eval(random_poly, x))
    # sigma (common permutation) evals
    for s in pk.sigmas_coeff:
        transcript.write_scalar(poly_eval(s, x))
    # per-proof permutation set evals: z(x), z(omega x), [z(omega^-(bf+1) x) unless last]
    x_next = domain.rotate_omega(x, 1)
    x_last = domain.rotate_omega(x, -(bf + 1))
    for p in range(num_proofs):
        nsets = len(perm_z_coeff[p])
        for s_idx, zc in enumerate(perm_z_coeff[p]):
            transcript.write_scalar(poly_eval(zc, x))
            transcript.write_scalar(poly_eval(zc, x_next))
            if s_idx + 1 < nsets:
                transcript.write_scalar(poly_eval(zc, x_last))
    # lookup evals: z(x), z(wx), a'(x), a'(w^-1 x), s'(x)
    x_inv = domain.rotate_omega(x, -1)
    for p in range(num_proofs):
        for lkc in lookup_coeffs[p]:
            transcript.write_scalar(poly_eval(lkc["z"], x))
            transcript.write_scalar(poly_eval(lkc["z"], x_next))
            transcript.write_scalar(poly_eval(lkc["a"], x))
            transcript.write_scalar(poly_eval(lkc["a"], x_inv))
            transcript.write_scalar(poly_eval(lkc["s"], x))

    v = transcript.squeeze_challenge()

    # -- 9. GWC multiopen: one W per rotation set -------------------------
    plan = query_plan(vk, num_proofs)
    for rot, refs in rotation_sets(plan):
        z = domain.rotate_omega(x, rot)
        # verifier folds Sum v^j q_j with the FIRST-pushed query at v^0
        # (multiopen.rs:56-57 folds .rev() with acc*v + q)
        q: list[int] = []
        for ref in reversed(refs):
            pcoeffs = poly_for(ref)
            q = poly_add(poly_scale(q, v), pcoeffs) if q else list(pcoeffs)
        w = kate_division(q, z)
        transcript.write_point(params.commit_coeff(w) if w else None)

    return transcript.finalize()


def _permute_pair(a_rows: list[int], s_rows: list[int]) -> tuple[list[int], list[int]]:
    """halo2 permute_expression_pair over usable rows."""
    usable = len(a_rows)
    a_perm = sorted(a_rows)
    counts: dict[int, int] = {}
    for v in s_rows:
        counts[v] = counts.get(v, 0) + 1
    s_perm = [0] * usable
    repeated_rows = []
    for i, v in enumerate(a_perm):
        if i == 0 or v != a_perm[i - 1]:
            s_perm[i] = v
            if counts.get(v, 0) <= 0:
                missing = sorted({u for u in a_rows if u not in counts})
                raise ValueError(
                    f"lookup input value not present in table: "
                    f"{len(missing)} distinct missing values over "
                    f"{usable} rows; first={hex(missing[0])} "
                    f"({missing[0].bit_length()} bits), "
                    f"last={hex(missing[-1])} "
                    f"({missing[-1].bit_length()} bits); table has "
                    f"{len(counts)} distinct values, "
                    f"max={hex(max(counts))}")
            counts[v] -= 1
        else:
            repeated_rows.append(i)
    for value in sorted(counts):
        for _ in range(counts[value]):
            row = repeated_rows.pop()
            s_perm[row] = value
    assert not repeated_rows
    return a_perm, s_perm


def _compute_h(
    pk: ProvingKey, params: ParamsKZG, num_proofs: int,
    advice_coeff, instance_coeff, lookups_data, perm_z,
    challenges: list[int], theta: int, beta: int, gamma: int, y: int,
) -> list[int]:
    """Numerator N(X) = y-fold of all constraint polynomials, then / (X^n - 1).

    Expression order must equal the verifier's fold order in params.rs
    queries(): per proof -> gate polys, permutation expressions, lookup
    expressions; Horner-folded by y (vanish.rs:36 via mul_add_accumulate).
    """
    vk = pk.vk
    cs = vk.cs
    domain = pk.domain
    n = domain.n
    bf = cs.blinding_factors()
    usable = n - (bf + 1)
    chunk_len = cs.permutation_chunk_len()

    l0 = _lagrange_basis_poly(domain, 0)
    l_last = _lagrange_basis_poly(domain, usable)
    l_blind = [0]
    for r in range(usable + 1, n):
        l_blind = poly_add(l_blind, _lagrange_basis_poly(domain, r))
    one_minus_ll_lb = poly_add(poly_scale(poly_add(l_last, l_blind), R - 1), [1])

    exprs: list[list[int]] = []

    for p in range(num_proofs):
        def expr_poly(e: Expression) -> list[int]:
            return e.evaluate(
                constant=lambda vv: [vv],
                fixed=lambda q: poly_rotate(pk.fixed_coeff[cs.fixed_queries[q][0]], pow(domain.omega, cs.fixed_queries[q][1] % (n), R)),
                advice=lambda q: poly_rotate(advice_coeff[p][cs.advice_queries[q][0]], pow(domain.omega, cs.advice_queries[q][1] % n, R)),
                instance=lambda q: poly_rotate(instance_coeff[p][cs.instance_queries[q][0]], pow(domain.omega, cs.instance_queries[q][1] % n, R)),
                challenge=lambda i: [challenges[i]],
                neg=lambda a: poly_scale(a, R - 1),
                add=poly_add,
                mul=poly_mul,
                scale=lambda a, s: poly_scale(a, s),
            )

        # gates
        for _, polys in cs.gates:
            for g in polys:
                exprs.append(expr_poly(g))

        # permutation expressions (permutation.rs:53-140)
        sets = perm_z[p]
        sets_coeff = [domain.lagrange_to_coeff(z) for z in sets]
        if sets:
            z0 = sets_coeff[0]
            exprs.append(poly_mul(l0, poly_add([1], poly_scale(z0, R - 1))))
            zl = sets_coeff[-1]
            exprs.append(poly_mul(l_last, poly_add(poly_mul(zl, zl), poly_scale(zl, R - 1))))
            for s_idx in range(1, len(sets_coeff)):
                cur = sets_coeff[s_idx]
                prev_rot = poly_rotate(sets_coeff[s_idx - 1], pow(domain.omega, (-(bf + 1)) % n, R))
                exprs.append(poly_mul(poly_add(cur, poly_scale(prev_rot, R - 1)), l0))
            for chunk_idx0, chunk_start in enumerate(range(0, len(cs.permutation_columns), chunk_len)):
                chunk = cs.permutation_columns[chunk_start : chunk_start + chunk_len]
                zc = sets_coeff[chunk_idx0]
                left = poly_rotate(zc, domain.omega)
                right = list(zc)
                delta_pow = pow(FR_DELTA, chunk_idx0 * chunk_len, R)
                for j, col in enumerate(chunk):
                    qidx = cs.get_any_query_index(col, 0)
                    if col.kind == "advice":
                        vp = advice_coeff[p][cs.advice_queries[qidx][0]]
                    elif col.kind == "fixed":
                        vp = pk.fixed_coeff[cs.fixed_queries[qidx][0]]
                    else:
                        vp = instance_coeff[p][cs.instance_queries[qidx][0]]
                    sigma = pk.sigmas_coeff[chunk_start + j]
                    left = poly_mul(left, poly_add(poly_add(vp, poly_scale(sigma, beta)), [gamma]))
                    # v + delta^j beta X + gamma
                    bx = [gamma, beta * delta_pow % R]
                    right = poly_mul(right, poly_add(vp, bx))
                    delta_pow = delta_pow * FR_DELTA % R
                exprs.append(poly_mul(poly_add(left, poly_scale(right, R - 1)), one_minus_ll_lb))

        # lookup expressions (lookup.rs:35-118)
        for lk_idx, lk in enumerate(lookups_data[p]):
            arg = cs.lookups[lk_idx]
            zc = domain.lagrange_to_coeff(lk["z"])
            ac = domain.lagrange_to_coeff(lk["a_perm"])
            sc = domain.lagrange_to_coeff(lk["s_perm"])
            z_next = poly_rotate(zc, domain.omega)
            a_prev = poly_rotate(ac, domain.omega_inv)
            input_poly = [0]
            for e in arg.input_expressions:
                input_poly = poly_add(poly_scale(input_poly, theta), expr_poly(e))
            table_poly = [0]
            for e in arg.table_expressions:
                table_poly = poly_add(poly_scale(table_poly, theta), expr_poly(e))
            exprs.append(poly_mul(l0, poly_add([1], poly_scale(zc, R - 1))))
            exprs.append(poly_mul(l_last, poly_add(poly_mul(zc, zc), poly_scale(zc, R - 1))))
            left = poly_mul(z_next, poly_mul(poly_add(ac, [beta]), poly_add(sc, [gamma])))
            right = poly_mul(zc, poly_mul(poly_add(input_poly, [beta]), poly_add(table_poly, [gamma])))
            exprs.append(poly_mul(poly_add(left, poly_scale(right, R - 1)), one_minus_ll_lb))
            a_minus_s = poly_add(ac, poly_scale(sc, R - 1))
            exprs.append(poly_mul(l0, a_minus_s))
            exprs.append(poly_mul(poly_mul(a_minus_s, poly_add(ac, poly_scale(a_prev, R - 1))), one_minus_ll_lb))

    num = [0]
    for e in exprs:
        num = poly_add(poly_scale(num, y), e)
    return poly_divide_vanishing(num, n)
