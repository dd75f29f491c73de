# Frozen copy of halo2_snark_aggregator_tpu_torch/protocol/verify.py for the benchmark's
# plain reference: imports rewritten to this folder, the native (C++)
# fast paths removed. It imports nothing of the program under test.
"""The halo2 verifier/aggregation protocol engine (context-generic).

Python counterpart of halo2-snark-aggregator-api/src/systems/halo2/
{verify,params,permutation,lookup,vanish,lagrange,multiopen}.rs — one
algorithm, every arithmetic context. Sections below cite the reference
file:line they mirror.
"""

from __future__ import annotations

import dataclasses

from . import bn254 as ff
from .domain import Domain
from .evaluation import CommitQuery, EvaluationQuery, Schema, print_points_profiling
from .plonk import Expression, VerifyingKey

# ---------------------------------------------------------------------------
# Gate expression evaluation (expression.rs:5-114)
# ---------------------------------------------------------------------------


def chip_evaluate(expr: Expression, ctx, schip, fixed, advice, instance, challenge, zero):
    return expr.evaluate(
        constant=lambda v: schip.assign_const(ctx, v),
        fixed=fixed,
        advice=advice,
        instance=instance,
        challenge=challenge,
        neg=lambda a: schip.sub(ctx, zero, a),
        add=lambda a, b: schip.add(ctx, a, b),
        mul=lambda a, b: schip.mul(ctx, a, b),
        scale=lambda a, f: schip.sum_with_coeff_and_constant(ctx, [(a, f)], 0),
    )


# ---------------------------------------------------------------------------
# Permutation argument (permutation.rs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PermutationEvaluatedSet:
    permutation_product_commitment: object
    permutation_product_eval: object
    permutation_product_next_eval: object
    permutation_product_last_eval: object | None


@dataclasses.dataclass
class PermutationEvaluated:
    key: str
    blinding_factors: int
    x: object
    sets: list[PermutationEvaluatedSet]
    evals: list  # column evals in permutation-column order
    chunk_len: int

    def expressions(self, ctx, schip, common, l_0, l_last, l_blind,
                    delta, beta, gamma, x, one):
        """permutation.rs:53-140."""
        res = []
        if self.sets:
            z_x = self.sets[0].permutation_product_eval
            res.append(schip.mul(ctx, l_0, schip.sub(ctx, one, z_x)))
            z_l = self.sets[-1].permutation_product_eval
            res.append(
                schip.mul(ctx, l_last, schip.sub(ctx, schip.mul(ctx, z_l, z_l), z_l))
            )
        for s, last_s in zip(self.sets[1:], self.sets):
            prev_last = last_s.permutation_product_last_eval
            res.append(
                schip.mul(ctx, schip.sub(ctx, s.permutation_product_eval, prev_last), l_0)
            )
        t0 = schip.mul(ctx, beta, x)
        t1 = schip.sub(ctx, one, schip.add(ctx, l_last, l_blind))
        perm_evals = common.permutation_evals
        for chunk_index, s in enumerate(self.sets):
            evals = self.evals[chunk_index * self.chunk_len : (chunk_index + 1) * self.chunk_len]
            sigma_evals = perm_evals[chunk_index * self.chunk_len : (chunk_index + 1) * self.chunk_len]
            left = s.permutation_product_next_eval
            right = s.permutation_product_eval
            if chunk_index == 0:
                delta_pow = one
            else:
                delta_pow = schip.pow_constant(ctx, delta, chunk_index * self.chunk_len)
            d = schip.mul(ctx, t0, delta_pow)
            for eval_, sigma_eval in zip(evals, sigma_evals):
                t2 = schip.add(ctx, eval_, gamma)
                left = schip.mul(
                    ctx, schip.add(ctx, t2, schip.mul(ctx, beta, sigma_eval)), left
                )
                right = schip.mul(ctx, schip.add(ctx, t2, d), right)
                d = schip.mul(ctx, delta, d)
            res.append(schip.mul(ctx, schip.sub(ctx, left, right), t1))
        return res

    def queries(self, x_next, x_last):
        """permutation.rs:142-182: all sets at (x, x_next), then all but the
        last set at x_last in reversed index order."""
        out = []
        for i, s in enumerate(self.sets):
            out.append(EvaluationQuery.new(
                0, f"{self.key}_permutation_product_commitment_{i}",
                self.x, s.permutation_product_commitment, s.permutation_product_eval))
            out.append(EvaluationQuery.new(
                1, f"{self.key}_permutation_product_commitment_{i}",
                x_next, s.permutation_product_commitment, s.permutation_product_next_eval))
        for i in range(len(self.sets) - 2, -1, -1):
            s = self.sets[i]
            out.append(EvaluationQuery.new(
                -(self.blinding_factors + 1),
                f"{self.key}_permutation_product_commitment_{i}",
                x_last, s.permutation_product_commitment, s.permutation_product_last_eval))
        return out


@dataclasses.dataclass
class PermutationCommon:
    key: str
    permutation_evals: list
    permutation_commitments: list

    def queries(self, x):
        return [
            EvaluationQuery.new(
                0, f"{self.key}_permutation_commitments{i}", x, c, e
            )
            for i, (c, e) in enumerate(
                zip(self.permutation_commitments, self.permutation_evals)
            )
        ]


# ---------------------------------------------------------------------------
# Lookup argument (lookup.rs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LookupEvaluated:
    key: str
    input_expressions: list
    table_expressions: list
    permuted_input_commitment: object
    permuted_table_commitment: object
    product_commitment: object
    product_eval: object
    product_next_eval: object
    permuted_input_eval: object
    permuted_input_inv_eval: object
    permuted_table_eval: object

    def expressions(self, ctx, schip, fixed_evals, instance_evals, advice_evals,
                    challenges, l_0, l_last, l_blind, theta, beta, gamma, zero, one):
        """lookup.rs:35-118 (five constraints)."""
        z_wx = self.product_next_eval
        z_x = self.product_eval
        a_x = self.permuted_input_eval
        s_x = self.permuted_table_eval
        a_invwx = self.permuted_input_inv_eval

        left = schip.mul(
            ctx,
            schip.mul(ctx, z_wx, schip.add(ctx, a_x, beta)),
            schip.add(ctx, s_x, gamma),
        )

        def eval_exprs(exprs):
            vals = [
                chip_evaluate(
                    e, ctx, schip,
                    fixed=lambda q: fixed_evals[q],
                    advice=lambda q: advice_evals[q],
                    instance=lambda q: instance_evals[q],
                    challenge=lambda i: challenges[i],
                    zero=zero,
                )
                for e in exprs
            ]
            return schip.mul_add_accumulate(ctx, vals, theta)

        input_eval = eval_exprs(self.input_expressions)
        table_eval = eval_exprs(self.table_expressions)

        t0 = schip.sub(ctx, one, schip.add(ctx, l_last, l_blind))
        t1 = schip.sub(ctx, a_x, s_x)
        return [
            schip.mul(ctx, l_0, schip.sub(ctx, one, z_x)),
            schip.mul(ctx, l_last, schip.sub(ctx, schip.mul(ctx, z_x, z_x), z_x)),
            schip.mul(
                ctx,
                schip.sub(
                    ctx,
                    left,
                    schip.mul(
                        ctx,
                        schip.mul(ctx, z_x, schip.add(ctx, input_eval, beta)),
                        schip.add(ctx, table_eval, gamma),
                    ),
                ),
                t0,
            ),
            schip.mul(ctx, l_0, t1),
            schip.mul(ctx, schip.mul(ctx, t1, schip.sub(ctx, a_x, a_invwx)), t0),
        ]

    def queries(self, x, x_inv, x_next):
        """lookup.rs:120-165."""
        return [
            EvaluationQuery.new(0, f"{self.key}_product_commitment", x,
                                self.product_commitment, self.product_eval),
            EvaluationQuery.new(0, f"{self.key}_permuted_input_commitment", x,
                                self.permuted_input_commitment, self.permuted_input_eval),
            EvaluationQuery.new(0, f"{self.key}_permuted_table_commitment", x,
                                self.permuted_table_commitment, self.permuted_table_eval),
            EvaluationQuery.new(-1, f"{self.key}_permuted_input_commitment", x_inv,
                                self.permuted_input_commitment, self.permuted_input_inv_eval),
            EvaluationQuery.new(1, f"{self.key}_product_commitment", x_next,
                                self.product_commitment, self.product_next_eval),
        ]


# ---------------------------------------------------------------------------
# Vanishing argument (vanish.rs)
# ---------------------------------------------------------------------------


class VanishEvaluated:
    def __init__(self, ctx, schip, expressions, y, xn, random_commitment,
                 random_eval, h_commitments, one, key):
        expected = schip.mul_add_accumulate(ctx, expressions, y)
        denom = schip.sub(ctx, xn, one)
        self.expected_h_eval = schip.div(ctx, expected, denom)
        h = None
        for i, c in enumerate(reversed(h_commitments)):
            node = Schema.commit(CommitQuery(key=f"{key}_h_commitment{i}", commitment=c))
            h = node if h is None else Schema.scalar(xn) * h + node
        self.h_commitment = h
        self.random_commitment = random_commitment
        self.random_eval = random_eval
        self.key = key

    def queries(self, x):
        return [
            EvaluationQuery.new_from_query(
                0, x, self.h_commitment + Schema.scalar(self.expected_h_eval)
            ),
            EvaluationQuery.new(
                0, f"{self.key}_random_commitment", x,
                self.random_commitment, self.random_eval),
        ]


# ---------------------------------------------------------------------------
# Verifier params + queries (params.rs) and multiopen folding (multiopen.rs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PlonkCommonSetup:
    l: int
    n: int


@dataclasses.dataclass
class VerifierParams:
    key: str
    gates: list  # [[Expression]]
    common: PlonkCommonSetup
    lookup_evaluated: list  # [proof][lookup]
    permutation_evaluated: list  # [proof]
    instance_commitments: list
    instance_evals: list
    instance_queries: list
    challenges: list
    advice_commitments: list
    advice_evals: list
    advice_queries: list
    fixed_commitments: list
    fixed_evals: list
    fixed_queries: list
    permutation_commitments: list
    permutation_evals: list
    vanish_commitments: list
    random_commitment: object
    w: list
    random_eval: object
    beta: object
    gamma: object
    theta: object
    delta: object
    x: object
    x_next: object
    x_last: object
    x_inv: object
    xn: object
    y: object
    u: object
    v: object
    omega: object
    zero: object
    one: object
    n: object
    omega_value: int  # host value for rotate_omega staging

    def x_rotate_omega(self, ctx, schip, at: int):
        """params.rs:57-72: x * omega^at with the omega power staged host-side."""
        base = self.omega_value if at >= 0 else pow(self.omega_value, -1, ff.R)
        omega_at = pow(base, abs(at), ff.R)
        return schip.sum_with_coeff_and_constant(ctx, [(self.x, omega_at)], 0)

    # -- Lagrange commitments (lagrange.rs:16-40) --------------------------
    def get_lagrange_commits(self, ctx, schip):
        n = self.n
        xi = self.x
        xi_n = self.xn
        one = self.one
        ws = [one]
        for i in range(1, self.common.l + 1):
            ws.append(schip.div(ctx, ws[i - 1], self.omega))
        out = []
        for i in range(self.common.l + 1):
            wi = ws[i]
            # ((wi / n) * (xi_n - one)) / (xi - wi)
            t = schip.div(ctx, wi, n)
            t = schip.mul(ctx, t, schip.sub(ctx, xi_n, one))
            out.append(schip.div(ctx, t, schip.sub(ctx, xi, wi)))
        return out

    # -- queries (params.rs:75-225) ----------------------------------------
    def queries(self, ctx, schip):
        x = self.x
        ls = self.get_lagrange_commits(ctx, schip)
        l_0 = ls[0]
        l_last = ls[self.common.l]
        l_blind = schip.sum_with_constant(ctx, ls[1 : self.common.l], 0)
        zero = self.zero

        pcommon = PermutationCommon(
            key=self.key,
            permutation_evals=self.permutation_evals,
            permutation_commitments=self.permutation_commitments,
        )

        expressions = []
        for k in range(len(self.advice_evals)):
            advice_evals = self.advice_evals[k]
            instance_evals = self.instance_evals[k]
            permutation = self.permutation_evaluated[k]
            lookups = self.lookup_evaluated[k]
            for gate in self.gates:
                for poly in gate:
                    expressions.append(
                        chip_evaluate(
                            poly, ctx, schip,
                            fixed=lambda q: self.fixed_evals[q],
                            advice=lambda q: advice_evals[q],
                            instance=lambda q: instance_evals[q],
                            challenge=lambda i: self.challenges[i],
                            zero=zero,
                        )
                    )
            expressions.extend(
                permutation.expressions(
                    ctx, schip, pcommon, l_0, l_last, l_blind,
                    self.delta, self.beta, self.gamma, x, self.one,
                )
            )
            for lookup in lookups:
                expressions.extend(
                    lookup.expressions(
                        ctx, schip, self.fixed_evals, instance_evals, advice_evals,
                        self.challenges, l_0, l_last, l_blind,
                        self.theta, self.beta, self.gamma, self.zero, self.one,
                    )
                )

        queries = []
        for i in range(len(self.instance_commitments)):
            instance_commitments = self.instance_commitments[i]
            instance_evals = self.instance_evals[i]
            advice_commitments = self.advice_commitments[i]
            advice_evals = self.advice_evals[i]
            permutation = self.permutation_evaluated[i]
            lookups = self.lookup_evaluated[i]

            for query_index, (column, at) in enumerate(self.instance_queries):
                queries.append(EvaluationQuery.new(
                    at, f"{self.key}_instance_commitments{column}",
                    self.x_rotate_omega(ctx, schip, at),
                    instance_commitments[column], instance_evals[query_index]))
            for query_index, (column, at) in enumerate(self.advice_queries):
                queries.append(EvaluationQuery.new(
                    at, f"{self.key}_advice_commitments{column}",
                    self.x_rotate_omega(ctx, schip, at),
                    advice_commitments[column], advice_evals[query_index]))
            queries.extend(permutation.queries(self.x_next, self.x_last))
            for lookup in lookups:
                queries.extend(lookup.queries(x, self.x_inv, self.x_next))

        for query_index, (column, at) in enumerate(self.fixed_queries):
            queries.append(EvaluationQuery.new(
                at, f"{self.key}_fixed_commitments{column}",
                self.x_rotate_omega(ctx, schip, at),
                self.fixed_commitments[column], self.fixed_evals[query_index]))
        queries.extend(pcommon.queries(x))

        vanish = VanishEvaluated(
            ctx, schip, expressions, self.y, self.xn,
            self.random_commitment, self.random_eval,
            self.vanish_commitments, self.one, self.key,
        )
        queries.extend(vanish.queries(x))
        return queries

    # -- multiopen (multiopen.rs:24-103) -----------------------------------
    def batch_multi_open_proofs(self, ctx, schip, pchip) -> "MultiOpenProof":
        queries = self.queries(ctx, schip)

        # group by rotation, first-seen order
        points: list[tuple[int, object, list[Schema]]] = []
        for q in queries:
            for entry in points:
                if entry[0] == q.rotation:
                    entry[2].append(q.s)
                    break
            else:
                points.append((q.rotation, q.point, [q.s]))

        assert len(self.w) == len(points), (len(self.w), len(points))

        w_x = None
        w_g = None
        for i in reversed(range(len(points))):
            rotation, point, schemas = points[i]
            acc = None
            for s in reversed(schemas):
                acc = s if acc is None else Schema.scalar(self.v) * acc + s
            w_cq = CommitQuery(key=f"{self.key}_w{i}", commitment=self.w[i])
            w_commit = Schema.commit(w_cq)
            w_x = w_commit if w_x is None else Schema.scalar(self.u) * w_x + w_commit
            wg_term = Schema.scalar(point) * Schema.commit(w_cq) + acc
            w_g = wg_term if w_g is None else Schema.scalar(self.u) * w_g + wg_term
        return MultiOpenProof(w_x=w_x, w_g=w_g)


@dataclasses.dataclass
class MultiOpenProof:
    w_x: Schema
    w_g: Schema

    def estimate(self) -> int:
        return self.w_x.estimate() + self.w_g.estimate()


# ---------------------------------------------------------------------------
# Params builder: transcript replay (verify.rs:27-571)
# ---------------------------------------------------------------------------


class VerifierParamsBuilder:
    def __init__(self, ctx, nchip, schip, pchip, assigned_instances,
                 vk: VerifyingKey, params, transcript, key: str):
        self.ctx = ctx
        self.nchip = nchip
        self.schip = schip
        self.pchip = pchip
        self.assigned_instances = assigned_instances
        self.vk = vk
        self.params = params
        self.transcript = transcript
        self.key = key

    def _squeeze(self):
        return self.transcript.squeeze_challenge_scalar(self.ctx, self.nchip, self.schip)

    def _point(self):
        return self.transcript.read_point(self.ctx, self.nchip, self.schip, self.pchip)

    def _scalar(self):
        return self.transcript.read_scalar(self.ctx, self.nchip, self.schip)

    def build_params(self) -> VerifierParams:
        ctx, nchip, schip, pchip = self.ctx, self.nchip, self.schip, self.pchip
        vk = self.vk
        cs = vk.cs
        transcript = self.transcript

        # init_transcript (verify.rs:56-72): vk digest absorbed as common scalar
        digest = schip.assign_const(ctx, vk.transcript_repr())
        transcript.common_scalar(ctx, nchip, schip, digest)

        # instance commitments absorbed (verify.rs:74-92)
        for instance in self.assigned_instances:
            for p in instance:
                transcript.common_point(ctx, nchip, schip, pchip, p)

        num_proofs = len(self.assigned_instances)

        # advice commitments + phase challenges (verify.rs:350-391)
        advice_commitments = [
            [None] * cs.num_advice_columns for _ in range(num_proofs)
        ]
        challenges = [schip.assign_const(ctx, 0)] * cs.num_challenges
        for current_phase in cs.phases():
            for commits in advice_commitments:
                for col, phase in enumerate(cs.advice_column_phase):
                    if phase == current_phase:
                        commits[col] = self._point()
            for ch, phase in enumerate(cs.challenge_phase):
                if phase == current_phase:
                    challenges[ch] = self._squeeze()

        theta = self._squeeze()

        lookups_permuted = [
            [(self._point(), self._point()) for _ in cs.lookups]
            for _ in range(num_proofs)
        ]

        beta = self._squeeze()
        gamma = self._squeeze()

        nsets = cs.permutation_num_chunks()
        permutations_committed = [
            [self._point() for _ in range(nsets)] for _ in range(num_proofs)
        ]
        lookups_committed = [
            [self._point() for _ in cs.lookups] for _ in range(num_proofs)
        ]

        random_commitment = self._point()
        y = self._squeeze()
        h_commitments = [self._point() for _ in range(vk.quotient_poly_degree())]

        bf = cs.blinding_factors()
        l = bf + 1
        n = vk.n
        domain = Domain(vk.k)

        x = self._squeeze()

        instance_evals = [
            [self._scalar() for _ in cs.instance_queries] for _ in range(num_proofs)
        ]
        advice_evals = [
            [self._scalar() for _ in cs.advice_queries] for _ in range(num_proofs)
        ]
        fixed_evals = [self._scalar() for _ in cs.fixed_queries]
        random_eval = self._scalar()
        permutation_evals = [self._scalar() for _ in vk.permutation_commitments]

        # per-proof permutation set evals (verify.rs:198-289)
        permutation_evaluated = []
        for p in range(num_proofs):
            sets = []
            for s_idx in range(nsets):
                pe = self._scalar()
                pne = self._scalar()
                ple = self._scalar() if s_idx + 1 < nsets else None
                sets.append(PermutationEvaluatedSet(
                    permutations_committed[p][s_idx], pe, pne, ple))
            # column evals in permutation-column order via cur-rotation queries
            evals = []
            for col in cs.permutation_columns:
                qidx = cs.get_any_query_index(col, 0)
                if col.kind == "advice":
                    evals.append(advice_evals[p][qidx])
                elif col.kind == "fixed":
                    evals.append(fixed_evals[qidx])
                else:
                    evals.append(instance_evals[p][qidx])
            permutation_evaluated.append(PermutationEvaluated(
                key=f"{self.key}_{p}",
                blinding_factors=bf,
                x=x,
                sets=sets,
                evals=evals,
                chunk_len=cs.permutation_chunk_len(),
            ))

        # lookups evaluated (verify.rs:291-340)
        lookup_evaluated = []
        for p in range(num_proofs):
            per = []
            for j, arg in enumerate(cs.lookups):
                product_eval = self._scalar()
                product_next_eval = self._scalar()
                permuted_input_eval = self._scalar()
                permuted_input_inv_eval = self._scalar()
                permuted_table_eval = self._scalar()
                per.append(LookupEvaluated(
                    key=f"{self.key}_{p}_{j}",
                    input_expressions=arg.input_expressions,
                    table_expressions=arg.table_expressions,
                    permuted_input_commitment=lookups_permuted[p][j][0],
                    permuted_table_commitment=lookups_permuted[p][j][1],
                    product_commitment=lookups_committed[p][j],
                    product_eval=product_eval,
                    product_next_eval=product_next_eval,
                    permuted_input_eval=permuted_input_eval,
                    permuted_input_inv_eval=permuted_input_inv_eval,
                    permuted_table_eval=permuted_table_eval,
                ))
            lookup_evaluated.append(per)

        fixed_commitments = [
            pchip.assign_const(ctx, c) for c in vk.fixed_commitments
        ]
        permutation_commitments = [
            pchip.assign_const(ctx, c) for c in vk.permutation_commitments
        ]

        v = self._squeeze()

        w = []
        while True:
            try:
                w.append(self._point())
            except EOFError:
                break

        u = self._squeeze()

        omega_value = domain.omega
        x_next = self._rotate(schip, x, omega_value, 1)
        x_last = self._rotate(schip, x, omega_value, -l)
        x_inv = self._rotate(schip, x, omega_value, -1)
        xn = schip.pow_constant(ctx, x, n)

        return VerifierParams(
            key=self.key,
            gates=[list(polys) for _, polys in cs.gates],
            common=PlonkCommonSetup(l=l, n=n),
            lookup_evaluated=lookup_evaluated,
            permutation_evaluated=permutation_evaluated,
            instance_commitments=self.assigned_instances,
            instance_evals=instance_evals,
            instance_queries=list(cs.instance_queries),
            challenges=challenges,
            advice_commitments=advice_commitments,
            advice_evals=advice_evals,
            advice_queries=list(cs.advice_queries),
            fixed_commitments=fixed_commitments,
            fixed_evals=fixed_evals,
            fixed_queries=list(cs.fixed_queries),
            permutation_commitments=permutation_commitments,
            permutation_evals=permutation_evals,
            vanish_commitments=h_commitments,
            random_commitment=random_commitment,
            random_eval=random_eval,
            w=w,
            beta=beta,
            gamma=gamma,
            theta=theta,
            delta=self.schip.assign_const(ctx, ff.FR_DELTA),
            x=x,
            x_next=x_next,
            x_last=x_last,
            x_inv=x_inv,
            xn=xn,
            y=y,
            u=u,
            v=v,
            omega=schip.assign_const(ctx, omega_value),
            zero=schip.assign_const(ctx, 0),
            one=schip.assign_const(ctx, 1),
            n=schip.assign_const(ctx, n),
            omega_value=omega_value,
        )

    def _rotate(self, schip, x, omega, at):
        base = omega if at >= 0 else pow(omega, -1, ff.R)
        omega_at = pow(base, abs(at), ff.R)
        return schip.sum_with_coeff_and_constant(self.ctx, [(x, omega_at)], 0)


# ---------------------------------------------------------------------------
# Instance commitments (verify.rs:574-649)
# ---------------------------------------------------------------------------


def assign_instance_commitment(ctx, schip, pchip, instances, vk: VerifyingKey, params):
    """instances: [proof][column][row] raw values. Returns (plain assigned
    scalars, [proof][column] assigned commitment points)."""
    plain = []
    commitments = []
    bf = vk.cs.blinding_factors()
    for instance in instances:
        assert len(instance) == vk.cs.num_instance_columns
        per_proof = []
        for column_values in instance:
            assert len(column_values) <= params.n - (bf + 1)
            assigned = [schip.assign_var(ctx, v) for v in column_values]
            plain.extend(assigned)
            acc = None
            for i, s in enumerate(assigned):
                ls = pchip.scalar_mul_constant(ctx, s, params.g_lagrange[i])
                acc = ls if acc is None else pchip.add(ctx, acc, ls)
            if acc is None:
                c = pchip.assign_const(ctx, None)
            else:
                c = pchip.normalize(ctx, acc)
            per_proof.append(c)
        commitments.append(per_proof)
    return plain, commitments


# ---------------------------------------------------------------------------
# Single-proof and aggregation verification (verify.rs:651-942)
# ---------------------------------------------------------------------------


def verify_single_proof_no_eval(ctx, nchip, schip, pchip, assigned_instances,
                                vk, params, transcript, key: str):
    builder = VerifierParamsBuilder(
        ctx, nchip, schip, pchip, assigned_instances, vk, params, transcript, key
    )
    chip_params = builder.build_params()
    proof = chip_params.batch_multi_open_proofs(ctx, schip, pchip)
    return proof, chip_params.advice_commitments[0]


def evaluate_multiopen_proof(ctx, schip, pchip, proof: MultiOpenProof, params):
    """evaluation + host pairing sanity check (verify.rs:690-745)."""
    one = schip.assign_one(ctx)
    left_s, left_e, names_wx = proof.w_x.eval(ctx, schip, pchip, one)
    right_s, right_e, names_wg = proof.w_g.eval(ctx, schip, pchip, one)
    print_points_profiling(names_wx + names_wg)
    generator = pchip.assign_one(ctx)
    if left_e is not None:
        left = pchip.add(ctx, left_s, pchip.scalar_mul(ctx, left_e, generator))
    else:
        left = left_s
    if right_e is not None:
        right = pchip.sub(ctx, right_s, pchip.scalar_mul(ctx, right_e, generator))
    else:
        right = right_s

    left_v = pchip.to_value(left)
    right_v = pchip.to_value(right)
    success = ff.pairing_check(
        [(left_v, params.s_g2), (right_v, ff.g2_neg(params.g2))]
    )
    return left, right, success


@dataclasses.dataclass
class ProofData:
    instances: list  # [proof][column][row]
    transcript: object
    key: str


@dataclasses.dataclass
class CircuitProof:
    name: str
    vk: VerifyingKey
    params: object
    proofs: list  # [ProofData]


def verify_single_proof_in_chip(ctx, nchip, schip, pchip, circuit: CircuitProof):
    proof_data = circuit.proofs[0]
    plain, commitments = assign_instance_commitment(
        ctx, schip, pchip, proof_data.instances, circuit.vk, circuit.params
    )
    proof, advice_commitments = verify_single_proof_no_eval(
        ctx, nchip, schip, pchip, commitments, circuit.vk, circuit.params,
        proof_data.transcript, "",
    )
    w_x, w_g, ok = evaluate_multiopen_proof(ctx, schip, pchip, proof, circuit.params)
    return w_x, w_g, plain, advice_commitments, ok


def verify_aggregation_proofs_in_chip(ctx, nchip, schip, pchip,
                                      circuits: list[CircuitProof], transcript):
    """verify_aggregation_proofs_in_chip (verify.rs:835-942): per-proof
    no-eval verification; inner transcripts' final squeezes absorbed into the
    aggregation transcript; lambda-RLC fold of (w_x, w_g) ASTs; one evaluation."""
    plain_assigned_instances = []
    folded: list[tuple[MultiOpenProof, list]] = []

    # commitment-name dedup in the schema eval requires globally distinct
    # per-proof keys (evaluation.rs key-dedup at 250-268)
    keys = [pd.key for c in circuits for pd in c.proofs]
    assert len(keys) == len(set(keys)), f"ProofData keys must be distinct: {keys}"

    for circuit in circuits:
        for proof_data in circuit.proofs:
            plain, commitments = assign_instance_commitment(
                ctx, schip, pchip, proof_data.instances, circuit.vk, circuit.params
            )
            plain_assigned_instances.extend(plain)
            p, c = verify_single_proof_no_eval(
                ctx, nchip, schip, pchip, commitments, circuit.vk, circuit.params,
                proof_data.transcript, proof_data.key,
            )
            folded.append((p, c))
        # absorb each inner transcript's final squeeze (verify.rs:909-913)
        for proof_data in circuit.proofs:
            s = proof_data.transcript.squeeze_challenge_scalar(ctx, nchip, schip)
            transcript.common_scalar(ctx, nchip, schip, s)

    aggregation_challenge = transcript.squeeze_challenge_scalar(ctx, nchip, schip)

    acc = None
    commits = []
    for proof, c in folded:
        if acc is None:
            acc = proof
        else:
            acc = MultiOpenProof(
                w_x=Schema.scalar(aggregation_challenge) * acc.w_x + proof.w_x,
                w_g=Schema.scalar(aggregation_challenge) * acc.w_g + proof.w_g,
            )
        commits.append(c)

    w_x, w_g, ok = evaluate_multiopen_proof(ctx, schip, pchip, acc, circuits[0].params)
    return w_x, w_g, plain_assigned_instances, commits, ok
