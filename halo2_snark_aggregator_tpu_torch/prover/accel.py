"""The accelerated PLONK prover on one device: keygen and create_proof with
every polynomial as (n, 8) Montgomery Fr words on the card.

Port of halo2_snark_aggregator_tpu/prover/accel.py (`AccelParams`,
`AccelPk`, `keygen_accel`, `create_proof_accel`, `_compute_h_sharded` and
their helpers). The pipeline is the reference's:

  * Lagrange <-> coefficient moves and coset extensions are NTTs, batched
    where the prover has lists of columns (ops/ntt.ntt_batch: the pass and
    scale kernels; a column list is one batch);
  * products, sums and differences of polynomials are the field kernel
    (ops/field.elementwise), except where a whole expression is evaluated
    row by row: the quotient's folds (one program a proof, one launch a
    coset shard), the permutation's grand-product factors and the
    opening's combinations are row programs (prover/quotient_program.py)
    run by the row-program kernel (ops/field.run_program);
  * commitments are Pippenger MSMs: on the device through ops/msm.msm_totals
    (the reference's split plan, as `msm_staged_split` commits, built on
    the card; the accumulate and reduce kernels; window `msm_window`) over
    the affine SRS table, or on the host through the
    native Pippenger (`commit_mode`; by default the params' device decides,
    and the reference's "auto" rule, host MSMs up to k = 22 while the
    native library loads, is not ported);
  * the quotient h(X) is evaluated one coset shard at a time
    (`_compute_h_sharded`): shard s holds evaluations on zeta w_ext^s H (the
    columns it reads extended in one batch), a rotation is a row offset,
    and the vanishing divisor is one constant a shard;
  * grand products are log-depth doubling prefix products and one batched
    inversion; KZG openings use the NTT form of Kate division.

Bit-exact contract: `create_proof_accel` writes the same bytes as
prover/prove.create_proof (same transcript layout, same blinding RNG call
order), at K=16 and at the K=18 131-column fixture alike.

The reference's spill mode (`spill=`: polynomials held on the host, the
extension cache capped, for a 16 GB TPU) is not ported, since nothing
comes near the card's memory: on one H100 80GB the K=18 131-column proof
peaks at 10.9 GB allocated (its quotient stage: the 321 stacked columns
and their coset extension), and the k=22 aggregator, scaled from that by
bytes per quotient column and row to its 44 columns, is estimated at
23.9 GB; the rule ports it above 72 GB (prove.py `working_set`).
"""

from __future__ import annotations

import contextlib
import logging
import random as _random
import time

import numpy as np
import torch

from .. import device as dv
from ..ff import bn254 as ff
from ..ff.bn254 import FR_DELTA, FR_GENERATOR, R
from ..ops import curve as cv
from ..ops import field as fo
from ..ops import msm as msm_ops
from ..ops.ntt import ntt_batch
from ..protocol.plonk import ConstraintSystem, Expression, VerifyingKey
from ..protocol.queryplan import query_plan, rotation_sets
from .domain import Domain, omega_for_k
from .keygen import Assignment, ProvingKey
from .kzg import ParamsKZG
from .prove import _permute_pair
from .quotient_program import compile_fold, compile_perm_products, compile_quotient

FR = fo.FR
WORDS = fo.WORDS
log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Codecs and row-wise field ops (the field kernel)
# ---------------------------------------------------------------------------


def m_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fo.elementwise(fo.MUL, FR, a, b)


def m_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fo.elementwise(fo.ADD, FR, a, b)


def m_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fo.elementwise(fo.SUB, FR, a, b)


def m_to_mont(a: torch.Tensor) -> torch.Tensor:
    """Standard words (< r) -> Montgomery words: one product by R^2."""
    return m_mul(a, fo.const(FR, FR.r2, a.device, mont=False))


def m_from_mont(a: torch.Tensor) -> torch.Tensor:
    """Montgomery words -> standard words: one product by 1."""
    return m_mul(a, fo.const(FR, 1, a.device, mont=False))


def m_select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(cond[:, None], a, b)


def ints_to_std(vals) -> np.ndarray:
    """Python ints -> uint32 (n, 8) standard-form words of v mod r."""
    return fo.ints_to_words([int(v) % R for v in vals])


def ints_to_mont(vals, device) -> torch.Tensor:
    """Python ints -> (n, 8) Montgomery words on `device`."""
    return m_to_mont(fo.to_tensor(ints_to_std(vals), device))


def mont_to_ints(arr: torch.Tensor) -> list[int]:
    return fo.words_to_ints(m_from_mont(arr))


def mont_scalar(v: int, device) -> torch.Tensor:
    """One Fr value as a (1, 8) Montgomery word tensor."""
    return fo.const(FR, v % R, device)


def _bcast(scalar_mont: torch.Tensor, n: int) -> torch.Tensor:
    return scalar_mont.expand(n, WORDS)


def mont_powers(base: int, n: int, device) -> torch.Tensor:
    """[1, base, base^2, ..., base^(n-1)] Montgomery, by log-doubling."""
    return fo.mont_powers(FR, base, n, device)


def _sum_mont_host(v: torch.Tensor) -> int:
    """Exact sum of a (m, 8) Montgomery vector as a canonical int: word
    columns summed in int64 on the device (m < 2^31 rows of words below
    2^32), the carries and the Montgomery factor on the host."""
    cols = (v.to(torch.int64) & 0xFFFFFFFF).sum(dim=0).tolist()
    total = sum(int(c) << (32 * i) for i, c in enumerate(cols))
    return total * pow(1 << 256, -1, R) % R


def _cumprod_mont(v: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix product of a (n, 8) Montgomery vector (log-depth
    doubling with a ones-pad shift)."""
    n = v.shape[0]
    ones = _bcast(mont_scalar(1, v.device), n)
    d = 1
    while d < n:
        v = m_mul(v, torch.cat([ones[:d], v[:-d]]))
        d *= 2
    return v


def _eval_at(poly_mont: torch.Tensor, powers: torch.Tensor) -> int:
    """A coefficient-form poly at the point whose powers are `powers`."""
    return _sum_mont_host(m_mul(poly_mont, powers[: poly_mont.shape[0]]))


def _batch_inv(v: torch.Tensor) -> torch.Tensor:
    """Batched inversion by prefix and suffix products with one host
    inversion of the total (the reference's large-n path, here at every n).
    Every entry must be nonzero (the prover's denominators are shifted by
    random challenges); a zero entry raises."""
    n = v.shape[0]
    pre = _cumprod_mont(v)
    suf = torch.flip(_cumprod_mont(torch.flip(v, [0])), [0])
    total = mont_to_ints(pre[n - 1 :])[0]
    if total == 0:
        raise ZeroDivisionError("batched inversion of a vector with a zero entry")
    inv_total = _bcast(mont_scalar(pow(total, -1, R), v.device), n)
    one = mont_scalar(1, v.device)
    pre_shift = torch.cat([one, pre[:-1]])
    suf_shift = torch.cat([suf[1:], one])
    return m_mul(m_mul(pre_shift, suf_shift), inv_total)


def ntt_many(cols, k: int, inverse: bool, coset=None) -> list:
    """The NTTs of a list of (2^k, 8) columns, or of a (b, 2^k, 8) batch,
    as one `ntt_batch` (with its optional coset factor); the results are
    views of the batch, in order."""
    if len(cols) == 0:
        return []
    x = cols if torch.is_tensor(cols) else torch.stack(cols)
    return list(ntt_batch(x, k, inverse, coset=coset).unbind(0))


# ---------------------------------------------------------------------------
# Stage timer (host clock, a synchronize at every boundary)
# ---------------------------------------------------------------------------


class StageTimer:
    """Exclusive seconds per named span: a nested span's time is not
    counted in its parent. On the card, `peak_bytes[name]` is the most
    memory allocated while the span was innermost (the allocator's peak,
    read and reset at each boundary). Disabled, a span costs nothing and
    never synchronizes."""

    def __init__(self, device, enabled: bool):
        self.device = device
        self.enabled = enabled
        self.seconds: dict[str, float] = {}
        self.peak_bytes: dict[str, int] = {}
        self._stack: list[str] = []
        self._t = 0.0

    def _mark(self) -> None:
        dv.synchronize(self.device)
        now = time.perf_counter()
        peak = dv.peak_bytes(self.device)
        if self._stack:
            name = self._stack[-1]
            self.seconds[name] += now - self._t
            if peak is not None:
                self.peak_bytes[name] = max(self.peak_bytes.get(name, 0), peak)
        dv.reset_peak(self.device)
        self._t = now

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        self._mark()
        self._stack.append(name)
        self.seconds.setdefault(name, 0.0)
        try:
            yield
        finally:
            self._mark()
            self._stack.pop()


_NULL_TIMER = StageTimer(torch.device("cpu"), False)


# ---------------------------------------------------------------------------
# Device-resident SRS + Pippenger commitments
# ---------------------------------------------------------------------------


class AccelParams:
    """KZG params with the coefficient-basis SRS on the device.

    `g_dev` is (n, 3, 8) affine Montgomery Fq words (z = 1; the identity
    (0, 1, 0)). Every commitment goes through `commit_coeff_mont`; Lagrange
    commits are INTT + commit, the same group element. `commit_mode`:
    "device" (the MSM kernels) or "host" (the native Pippenger); left None,
    commits follow the params' device: the kernels on a CUDA device, the
    host Pippenger on the CPU.
    A list in `commit_log` receives one record per commit."""

    def __init__(self, k: int, g_dev, g2, s_g2, g_lagrange,
                 host: ParamsKZG | None = None, commit_mode: str | None = None,
                 *, device="cuda", msm_window: int = 8):
        self.k = k
        self.n = 1 << k
        self.device = dv.resolve(device)
        if commit_mode is None:
            commit_mode = "device" if self.device.type == "cuda" else "host"
        if commit_mode not in ("device", "host"):
            raise ValueError(f"unknown commit_mode {commit_mode!r}")
        self.g_dev = g_dev
        self.g2 = g2
        self.s_g2 = s_g2
        self.g_lagrange = g_lagrange
        self.host = host
        self.commit_mode = commit_mode
        self.msm_window = msm_window
        self.commit_log: list | None = None
        self._table = None
        self._g_host = None

    @staticmethod
    def from_params(params: ParamsKZG, commit_mode: str | None = None, *,
                    device="cuda", msm_window: int = 8) -> "AccelParams":
        dev = dv.resolve(device)
        g_dev = torch.stack(cv.from_affine_ints(params.g, dev), dim=1)
        return AccelParams(params.k, g_dev, params.g2, params.s_g2,
                           params.g_lagrange, host=params,
                           commit_mode=commit_mode, device=dev,
                           msm_window=msm_window)

    def g_host_points(self) -> list:
        """Affine int SRS points for host commits (from the device table
        when no host ParamsKZG came with it)."""
        if self.host is not None:
            return self.host.g
        if self._g_host is None:
            self._g_host = cv.to_affine_ints(self.g_dev.unbind(1))
        return self._g_host

    def table(self):
        """The accumulate kernel's affine table (every row checked)."""
        if self._table is None:
            self._table = msm_ops.affine_table(self.g_dev.unbind(1))
        return self._table

    def commit_coeff_mont(self, coeffs_mont: torch.Tensor):
        """Commit a Montgomery coefficient vector; an affine int point or
        None (the identity). A device commit keeps the scalars on the card:
        standard form, zero-padded to n, into ops/msm.msm_totals (the split
        plan built on the card) and the host row combine. With a
        `commit_log`, a device commit's record holds the plan's figures and
        `split_s`, its seconds by phase (scalars, plan, accumulate, reduce,
        combine; a synchronize at each boundary)."""
        record = self.commit_log is not None
        if record:
            dv.synchronize(self.device)
            t0 = time.perf_counter()
        stats: dict = {}
        if self.commit_mode == "host":
            scalars = mont_to_ints(coeffs_mont)
            out = ff.g1_msm(self.g_host_points()[: len(scalars)], scalars)
            mode = "host"
        else:
            split: dict[str, float] = {}
            marks = [t0] if record else None

            def lap(phase: str) -> None:
                if record:
                    dv.synchronize(self.device)
                    marks.append(time.perf_counter())
                    split[phase] = marks[-1] - marks[-2]

            pad = self.n - coeffs_mont.shape[0]
            std = m_from_mont(coeffs_mont)
            if pad:
                std = torch.cat([std, std.new_zeros((pad, WORDS))])
            lap("scalars")
            totals, weights = msm_ops.msm_totals(
                self.table(), std, self.msm_window,
                stats=stats if record else None, lap=lap)
            out = msm_ops.combine_rows_host(totals.unbind(1), weights,
                                            self.msm_window)
            lap("combine")
            if record:
                stats["split_s"] = split
            mode = "device"
        if record:
            self.commit_log.append(dict(mode=mode, seconds=time.perf_counter() - t0,
                                        **stats))
        return out

    def commit_lagrange_ints(self, values: list[int]):
        """Small commit in the Lagrange basis (instance columns)."""
        return ff.g1_msm(self.g_lagrange[: len(values)], values)


# ---------------------------------------------------------------------------
# Accelerated proving key and keygen
# ---------------------------------------------------------------------------


class AccelPk:
    """ProvingKey with all polynomials as device Montgomery vectors."""

    def __init__(self, vk: VerifyingKey, domain: Domain,
                 fixed_lagrange, fixed_coeff, sigmas_lagrange, sigmas_coeff):
        self.vk = vk
        self.domain = domain
        self.fixed_lagrange = fixed_lagrange
        self.fixed_coeff = fixed_coeff
        self.sigmas_lagrange = sigmas_lagrange
        self.sigmas_coeff = sigmas_coeff

    @staticmethod
    def from_host(pk: ProvingKey, device="cuda") -> "AccelPk":
        dev = dv.resolve(device)

        def up(cols):
            return [ints_to_mont(c, dev) for c in cols]

        return AccelPk(pk.vk, pk.domain, up(pk.fixed_lagrange),
                       up(pk.fixed_coeff), up(pk.sigmas_lagrange),
                       up(pk.sigmas_coeff))


def synthesize_keygen(circuit, k: int,
                      instances: list[list[int]] | None = None) -> Assignment:
    """The circuit's keygen synthesis at 2^k rows, as keygen_accel runs it
    (which takes it back as `assignment=`). Its `max_row_touched` + 1 is
    the rows the circuit uses; a row past 2^k's usable rows raises
    ValueError."""
    cs = ConstraintSystem()
    config = circuit.configure(cs)
    n = 1 << k
    assignment = Assignment(cs, n, n - (cs.blinding_factors() + 1), instances)
    circuit.synthesize(config, assignment)
    return assignment


def keygen_accel(circuit, k: int, params: AccelParams,
                 instances: list[list[int]] | None = None,
                 assignment: Assignment | None = None,
                 timer: StageTimer | None = None):
    """keygen_vk + keygen_pk on the device, identical (vk, sigma polys,
    commitments) to prover.keygen.keygen: the permutation cycle-splice over
    flat Python lists, sigmas gathered from an omega-power table on the
    device, NTTs and commitments on the device. Returns (vk, AccelPk).
    `timer` (a StageTimer) splits the time into synthesis, permutation (the
    union-find), ntt, commit and other (the host int conversions)."""
    timer = timer or _NULL_TIMER
    dev = params.device
    with timer.span("other"):
        n = 1 << k
        if assignment is None:
            log.info("keygen_accel: synthesizing (n=%d)...", n)
            with timer.span("synthesis"):
                assignment = synthesize_keygen(circuit, k, instances)
        cs = assignment.cs

        domain = Domain(k)
        fixed_lagrange = [ints_to_mont(col, dev) for col in assignment.fixed]
        with timer.span("ntt"):
            fixed_coeff = ntt_many(fixed_lagrange, k, inverse=True)

        with timer.span("permutation"):
            map_flat = _permutation_map(cs, assignment, n)

        # sigma[c][r] = delta^{mc} * omega^{mr}, (mc, mr) = mapping[c][r]
        ncols = map_flat.shape[0]
        omega_pows = mont_powers(domain.omega, n, dev)
        deltas = ints_to_mont([pow(FR_DELTA, c, R) for c in range(ncols)], dev)
        map_dev = map_flat.to(dev)
        sigmas_lagrange = [m_mul(omega_pows[map_dev[ci] % n],
                                 deltas[map_dev[ci] // n])
                           for ci in range(ncols)]
        del map_dev
        with timer.span("ntt"):
            sigmas_coeff = ntt_many(sigmas_lagrange, k, inverse=True)

        log.info("keygen_accel: committing %d fixed + %d sigma cols",
                 len(fixed_coeff), len(sigmas_coeff))
        with timer.span("commit"):
            fixed_commitments = [params.commit_coeff_mont(c) for c in fixed_coeff]
            permutation_commitments = [params.commit_coeff_mont(s)
                                       for s in sigmas_coeff]
        vk = VerifyingKey(k=k, cs=cs, fixed_commitments=fixed_commitments,
                          permutation_commitments=permutation_commitments)
    return vk, AccelPk(vk, domain, fixed_lagrange, fixed_coeff,
                       sigmas_lagrange, sigmas_coeff)


def _permutation_map(cs: ConstraintSystem, assignment: Assignment,
                     n: int) -> torch.Tensor:
    """The permutation's mapping as int64 (ncols, n) flat cells (column *
    n + row): the cycle-splice union-find over flat Python lists."""
    cols = cs.permutation_columns
    ncols = len(cols)
    col_pos = {c: i for i, c in enumerate(cols)}
    map_list = list(range(ncols * n))  # mapping[cell] -> cell'
    aux = list(range(ncols * n))

    def find(cell: int) -> int:
        root = cell
        while aux[root] != root:
            root = aux[root]
        while aux[cell] != root:  # path compression
            aux[cell], cell = root, aux[cell]
        return root

    for col_a, row_a, col_b, row_b in assignment.copies:
        a = col_pos[col_a] * n + row_a
        b = col_pos[col_b] * n + row_b
        ra, rb = find(a), find(b)
        if ra == rb:
            continue
        map_list[a], map_list[b] = map_list[b], map_list[a]
        aux[ra] = rb
    return torch.tensor(map_list, dtype=torch.int64).reshape(ncols, n)


# ---------------------------------------------------------------------------
# The prover
# ---------------------------------------------------------------------------


def create_proof_accel(
    apk: AccelPk,
    params: AccelParams,
    circuits: list,
    instances_per_proof: list[list[list[int]]],
    transcript,
    seed: int = 0,
    timer: StageTimer | None = None,
) -> bytes:
    """Drop-in for prover.prove.create_proof: identical transcript bytes
    for identical inputs and seed. `timer` (a StageTimer) splits the time
    into synthesis, ntt, commit, quotient, open and other."""
    timer = timer or _NULL_TIMER
    dev = params.device
    vk = apk.vk
    cs = vk.cs
    domain = apk.domain
    k, n = domain.k, domain.n
    bf = cs.blinding_factors()
    usable = n - (bf + 1)
    num_proofs = len(instances_per_proof)
    rng = _random.Random(seed)

    def rand_fr() -> int:
        return rng.randrange(R)

    def scalar(v: int) -> torch.Tensor:
        return _bcast(mont_scalar(v, dev), n)

    def ntts(cols, inverse: bool, coset=None):
        with timer.span("ntt"):
            return ntt_many(cols, k, inverse, coset)

    def commit(coeffs):
        with timer.span("commit"):
            return params.commit_coeff_mont(coeffs)

    def to_mont(vals):
        return ints_to_mont(vals, dev)

    one_v = scalar(1)

    with timer.span("other"):
        # -- 0. vk digest --------------------------------------------------
        transcript.common_scalar(vk.transcript_repr())

        # -- 1. instances --------------------------------------------------
        instance_lagrange = []  # [proof][col] (n, 8) Montgomery
        instance_coeff = []
        for insts in instances_per_proof:
            assert len(insts) == cs.num_instance_columns
            cols_l = []
            for vals in insts:
                assert len(vals) <= usable
                cols_l.append(to_mont(list(vals) + [0] * (n - len(vals))))
                transcript.common_point(params.commit_lagrange_ints(list(vals)))
            instance_lagrange.append(cols_l)
            instance_coeff.append(ntts(cols_l, True))

        # -- 2. advice: per-phase synthesis -> blind -> commit -> challenges
        # (mirrors prove.py exactly, including the blinding RNG call order)
        advice_lagrange = [[None] * cs.num_advice_columns for _ in range(num_proofs)]
        advice_coeff = [[None] * cs.num_advice_columns for _ in range(num_proofs)]
        assert len(circuits) == num_proofs
        challenges: dict[int, int] = {}
        for phase in cs.phases():
            for p in range(num_proofs):
                with timer.span("synthesis"):
                    config = circuits[p].configure(ConstraintSystem())
                    assignment = Assignment(cs, n, usable, instances_per_proof[p],
                                            challenges=challenges)
                    circuits[p].synthesize(config, assignment)
                in_phase = [c for c, ph in enumerate(cs.advice_column_phase)
                            if ph == phase]
                for col_idx in in_phase:
                    col = list(assignment.advice[col_idx])
                    for r in range(usable, n):
                        col[r] = rand_fr()
                    advice_lagrange[p][col_idx] = to_mont(col)
                coeffs = ntts([advice_lagrange[p][c] for c in in_phase], True)
                for col_idx, coeff in zip(in_phase, coeffs):
                    advice_coeff[p][col_idx] = coeff
                    transcript.write_point(commit(coeff))
            for ch_idx, ch_phase in enumerate(cs.challenge_phase):
                if ch_phase == phase:
                    challenges[ch_idx] = transcript.squeeze_challenge()
        challenge_list = [challenges.get(i, 0) for i in range(cs.num_challenges)]

        theta = transcript.squeeze_challenge()

        # -- expression evaluation over Lagrange rows ----------------------
        def eval_expr_rows(expr: Expression, p: int):
            def roll(arr, rot):
                return torch.roll(arr, -rot, dims=0) if rot else arr

            return expr.evaluate(
                constant=scalar,
                fixed=lambda q: roll(apk.fixed_lagrange[cs.fixed_queries[q][0]],
                                     cs.fixed_queries[q][1]),
                advice=lambda q: roll(advice_lagrange[p][cs.advice_queries[q][0]],
                                      cs.advice_queries[q][1]),
                instance=lambda q: roll(
                    instance_lagrange[p][cs.instance_queries[q][0]],
                    cs.instance_queries[q][1]),
                challenge=lambda i: scalar(challenge_list[i]),
                neg=lambda a: m_sub(torch.zeros_like(a), a),
                add=m_add,
                mul=m_mul,
                scale=lambda a, s: m_mul(a, scalar(s)),
            )

        def compress(exprs: list[Expression], p: int):
            theta_b = scalar(theta)
            out = torch.zeros((n, WORDS), dtype=torch.int32, device=dev)
            for e in exprs:
                out = m_add(m_mul(out, theta_b), eval_expr_rows(e, p))
            return out

        # -- 3. lookups: permuted pairs -------------------------------------
        lookups_data = []  # [proof][lookup] dict of device vectors
        for p in range(num_proofs):
            per_proof = []
            for arg in cs.lookups:
                a_rows = compress(arg.input_expressions, p)
                s_rows = compress(arg.table_expressions, p)
                with timer.span("synthesis"):
                    a_perm, s_perm = _permute_pair(mont_to_ints(a_rows)[:usable],
                                                   mont_to_ints(s_rows)[:usable])
                a_perm = a_perm + [rand_fr() for _ in range(n - usable)]
                s_perm = s_perm + [rand_fr() for _ in range(n - usable)]
                per_proof.append(dict(a_rows=a_rows, s_rows=s_rows,
                                      a_perm=to_mont(a_perm),
                                      s_perm=to_mont(s_perm)))
            lookups_data.append(per_proof)

        all_lookups = [lk for per_proof in lookups_data for lk in per_proof]
        perm_coeffs = ntts([lk[key] for lk in all_lookups
                            for key in ("a_perm", "s_perm")], True)
        for i, lk in enumerate(all_lookups):
            lk["a_coeff"], lk["s_coeff"] = perm_coeffs[2 * i : 2 * i + 2]
            transcript.write_point(commit(lk["a_coeff"]))
            transcript.write_point(commit(lk["s_coeff"]))

        beta = transcript.squeeze_challenge()
        gamma = transcript.squeeze_challenge()
        beta_b = scalar(beta)
        gamma_b = scalar(gamma)

        # -- 4. permutation z polynomials (log-depth grand products) --------
        chunk_len = cs.permutation_chunk_len()
        perm_cols = cs.permutation_columns
        omega_pows = mont_powers(domain.omega, n, dev)

        def col_rows(col, p):
            if col.kind == "advice":
                return advice_lagrange[p][col.index]
            if col.kind == "fixed":
                return apk.fixed_lagrange[col.index]
            return instance_lagrange[p][col.index]

        def grand_product(num, den, z0: int, tail_draws: list[int]):
            """z[0] = z0, z[i+1] = z[i] num[i] / den[i] for i < usable, then
            the random tail; returns (z, z[usable] as an int)."""
            cp = m_mul(_cumprod_mont(m_mul(num, _batch_inv(den))), scalar(z0))
            z = torch.cat([mont_scalar(z0, dev), cp[:usable]])
            z_last = mont_to_ints(z[usable : usable + 1])[0]
            if tail_draws:
                z = torch.cat([z, to_mont(tail_draws)])
            assert z.shape[0] == n
            return z, z_last

        usable_mask = torch.arange(n, device=dev) < usable

        perm_z = []  # [proof][set] Lagrange
        for p in range(num_proofs):
            sets = []
            last_z = 1
            for chunk_idx in range(0, len(perm_cols), chunk_len):
                chunk = perm_cols[chunk_idx : chunk_idx + chunk_len]
                cols = {("omega",): omega_pows}
                for j, col in enumerate(chunk):
                    cols[("v", j)] = col_rows(col, p)
                    cols[("sigma", j)] = apk.sigmas_lagrange[chunk_idx + j]
                num, den = [
                    fo.run_program(prog, [cols[key] for key in keys])
                    for prog, keys in compile_perm_products(
                        [pow(FR_DELTA, chunk_idx + j, R)
                         for j in range(len(chunk))], beta, gamma)]
                # mask the blinded tail out of the product (den = num = 1)
                num = m_select(usable_mask, num, one_v)
                den = m_select(usable_mask, den, one_v)
                tail = [rand_fr() for _ in range(n - usable - 1)]
                z, last_z = grand_product(num, den, last_z, tail)
                sets.append(z)
            perm_z.append(sets)

        z_coeffs = iter(ntts([z for sets in perm_z for z in sets], True))
        perm_z_coeff = [[next(z_coeffs) for _ in sets] for sets in perm_z]
        for p in range(num_proofs):
            for zc in perm_z_coeff[p]:
                transcript.write_point(commit(zc))

        # -- 5. lookup z polynomials ------------------------------------------
        for p in range(num_proofs):
            for lk in lookups_data[p]:
                num = m_mul(m_add(lk["a_rows"], beta_b), m_add(lk["s_rows"], gamma_b))
                den = m_mul(m_add(lk["a_perm"], beta_b), m_add(lk["s_perm"], gamma_b))
                num = m_select(usable_mask, num, one_v)
                den = m_select(usable_mask, den, one_v)
                tail = [rand_fr() for _ in range(n - usable - 1)]
                lk["z"], _ = grand_product(num, den, 1, tail)
        for lk, zc in zip(all_lookups, ntts([lk["z"] for lk in all_lookups], True)):
            lk["z_coeff"] = zc
            transcript.write_point(commit(zc))

        # -- 6. vanishing random poly ---------------------------------------
        random_poly = to_mont([rand_fr() for _ in range(n)])
        transcript.write_point(commit(random_poly))

        y = transcript.squeeze_challenge()

        # -- 7. quotient h via coset-sharded evaluation ---------------------
        with timer.span("quotient"):
            h_chunks = _compute_h_sharded(
                apk, num_proofs, advice_coeff, instance_coeff, lookups_data,
                perm_z_coeff, challenge_list, theta, beta, gamma, y, dev,
                ntts=ntts)
        qd = vk.quotient_poly_degree()
        assert len(h_chunks) >= qd
        h_pieces = h_chunks[:qd]
        for piece in h_pieces:
            transcript.write_point(commit(piece))

        x = transcript.squeeze_challenge()
        xn_b = scalar(pow(x, n, R))
        h_folded = torch.zeros((n, WORDS), dtype=torch.int32, device=dev)
        for piece in reversed(h_pieces):
            h_folded = m_add(m_mul(h_folded, xn_b), piece)

    with timer.span("open"):
        # -- 8. evaluations -------------------------------------------------
        def poly_for(ref: tuple):
            kind = ref[0]
            if kind == "instance":
                return instance_coeff[ref[1]][ref[2]]
            if kind == "advice":
                return advice_coeff[ref[1]][ref[2]]
            if kind == "perm_z":
                return perm_z_coeff[ref[1]][ref[2]]
            if kind == "lookup_z":
                return lookups_data[ref[1]][ref[2]]["z_coeff"]
            if kind == "lookup_a":
                return lookups_data[ref[1]][ref[2]]["a_coeff"]
            if kind == "lookup_s":
                return lookups_data[ref[1]][ref[2]]["s_coeff"]
            if kind == "fixed":
                return apk.fixed_coeff[ref[1]]
            if kind == "sigma":
                return apk.sigmas_coeff[ref[1]]
            if kind == "h":
                return h_folded
            if kind == "random":
                return random_poly
            raise KeyError(ref)

        powers_cache: dict = {}

        def ev(poly, z: int) -> int:
            if z not in powers_cache:
                powers_cache[z] = mont_powers(z, n, dev)
            return _eval_at(poly, powers_cache[z])

        for p in range(num_proofs):
            for (col, rot) in cs.instance_queries:
                transcript.write_scalar(ev(instance_coeff[p][col],
                                           domain.rotate_omega(x, rot)))
        for p in range(num_proofs):
            for (col, rot) in cs.advice_queries:
                transcript.write_scalar(ev(advice_coeff[p][col],
                                           domain.rotate_omega(x, rot)))
        for (col, rot) in cs.fixed_queries:
            transcript.write_scalar(ev(apk.fixed_coeff[col],
                                       domain.rotate_omega(x, rot)))
        transcript.write_scalar(ev(random_poly, x))
        for s in apk.sigmas_coeff:
            transcript.write_scalar(ev(s, x))
        x_next = domain.rotate_omega(x, 1)
        x_last = domain.rotate_omega(x, -(bf + 1))
        for p in range(num_proofs):
            nsets = len(perm_z_coeff[p])
            for s_idx, zc in enumerate(perm_z_coeff[p]):
                transcript.write_scalar(ev(zc, x))
                transcript.write_scalar(ev(zc, x_next))
                if s_idx + 1 < nsets:
                    transcript.write_scalar(ev(zc, x_last))
        x_inv = domain.rotate_omega(x, -1)
        for p in range(num_proofs):
            for lk in lookups_data[p]:
                transcript.write_scalar(ev(lk["z_coeff"], x))
                transcript.write_scalar(ev(lk["z_coeff"], x_next))
                transcript.write_scalar(ev(lk["a_coeff"], x))
                transcript.write_scalar(ev(lk["a_coeff"], x_inv))
                transcript.write_scalar(ev(lk["s_coeff"], x))

        v = transcript.squeeze_challenge()

        # -- 9. GWC multiopen: NTT-form Kate division per rotation set ------
        plan = query_plan(vk, num_proofs)
        for rot, refs in rotation_sets(plan):
            z = domain.rotate_omega(x, rot)
            q = fo.run_program(compile_fold(len(refs), v),
                               [poly_for(ref) for ref in reversed(refs)])
            qz = ev(q, z)
            # w(omega^i) = (q(omega^i) - q(z)) / (omega^i - z)
            den = m_sub(omega_pows, scalar(z))
            w_lag = m_mul(m_sub(ntts([q], False)[0], scalar(qz)),
                          _batch_inv(den))
            transcript.write_point(commit(ntts([w_lag], True)[0]))

    return transcript.finalize()


# ---------------------------------------------------------------------------
# Coset-sharded quotient evaluation
# ---------------------------------------------------------------------------


def _compute_h_sharded(
    apk: AccelPk, num_proofs: int, advice_coeff, instance_coeff,
    lookups_data, perm_z_coeff, challenges: list[int],
    theta: int, beta: int, gamma: int, y: int, dev, ntts,
) -> list[torch.Tensor]:
    """The quotient's coefficient chunks [h_0 .. h_{ratio-1}] (each (n, 8)
    Montgomery), low chunk first, one size-n coset shard at a time.

    Shard s holds evaluations at {zeta w_ext^s omega^t}_t. The numerator's
    folds are one row program (prover/quotient_program.compile_quotient),
    compiled once and run once a shard over the shard's extended columns:
    a rotation by `rot` rows reads row (t + rot) mod n of the shard. The
    vanishing polynomial X^n - 1 is the constant zeta^n w_ext^{sn} - 1 on
    shard s. `ntts(cols, inverse, coset=None)` (`ntt_many` over this
    domain) runs every NTT."""
    vk = apk.vk
    cs = vk.cs
    domain = apk.domain
    k, n = domain.k, domain.n
    bf = cs.blinding_factors()
    usable = n - (bf + 1)
    ratio = 1  # coset shards: the least power of two >= deg - 1
    while ratio < max(cs.degree() - 1, 1):
        ratio *= 2
    k_ext = k + (ratio.bit_length() - 1)
    w_ext = omega_for_k(k_ext)
    zeta = FR_GENERATOR
    assert pow(zeta, 1 << k_ext, R) != 1

    def scalar(v: int) -> torch.Tensor:
        return _bcast(mont_scalar(v, dev), n)

    prog, keys = compile_quotient(cs, num_proofs, challenges, theta, beta,
                                  gamma, y)

    # l0 / l_last / l_blind coefficient forms, and p(X) = X
    onehot = torch.zeros((3, n, WORDS), dtype=torch.int32)  # standard form
    onehot[0, 0, 0] = onehot[1, usable, 0] = 1
    onehot[2, usable + 1 :, 0] = 1
    indicators = ntts(m_to_mont(onehot.to(dev)), True)
    x_poly_c = ints_to_mont([0, 1] + [0] * (n - 2), dev)

    def coeff_of(key: tuple) -> torch.Tensor:
        kind = key[0]
        if kind in ("l0", "l_last", "l_blind"):
            return indicators[("l0", "l_last", "l_blind").index(kind)]
        if kind == "x":
            return x_poly_c
        if kind == "fixed":
            return apk.fixed_coeff[key[1]]
        if kind == "sigma":
            return apk.sigmas_coeff[key[1]]
        p, i = key[1], key[2]
        if kind == "advice":
            return advice_coeff[p][i]
        if kind == "instance":
            return instance_coeff[p][i]
        if kind == "perm_z":
            return perm_z_coeff[p][i]
        return lookups_data[p][i][{"lookup_z": "z_coeff", "lookup_a": "a_coeff",
                                   "lookup_s": "s_coeff"}[kind]]

    # each distinct column is extended once a shard; the table is keyed by
    # id and holds the column itself, so a live entry's id cannot be taken
    # by another tensor
    held: dict[int, tuple[torch.Tensor, int]] = {}
    col_index = []
    for key in keys:
        col = coeff_of(key)
        col_index.append(held.setdefault(id(col), (col, len(held)))[1])
    coeffs = torch.stack([col for col, _ in held.values()])

    shards = []  # F_s = INTT(shard evals of h)
    for s in range(ratio):
        coset = zeta * pow(w_ext, s, R) % R
        ext = ntts(coeffs, False, coset=mont_powers(coset, n, dev))
        acc = fo.run_program(prog, [ext[i] for i in col_index])
        del ext
        # divide by the vanishing constant zeta^n w_ext^{sn} - 1
        vanish = (pow(zeta, n, R) * pow(w_ext, s * n, R) - 1) % R
        shards.append(ntts([m_mul(acc, scalar(pow(vanish, -1, R)))], True)[0])

    # recombine shards into coefficient chunks:
    # F_s[m] = w_ext^{sm} sum_u d[m,u] phi^{su}, phi = w_ext^n,
    # d[m,u] = c[m+un] zeta^(m+un)
    phi = pow(w_ext, n, R)
    g_vecs = []
    for s in range(ratio):
        ws_inv = pow(pow(w_ext, s, R), -1, R) if s else 1
        g_vecs.append(m_mul(shards[s], mont_powers(ws_inv, n, dev)))
    ratio_inv = pow(ratio, -1, R)
    zeta_inv = pow(zeta, -1, R)
    zeta_inv_pows = mont_powers(zeta_inv, n, dev)
    chunks = []
    for u in range(ratio):
        d_u = torch.zeros((n, WORDS), dtype=torch.int32, device=dev)
        for s in range(ratio):
            w = pow(pow(phi, s * u, R), -1, R) * ratio_inv % R
            d_u = m_add(d_u, m_mul(g_vecs[s], scalar(w)))
        # c[m+un] = d[m,u] zeta^{-(m+un)}
        c_u = m_mul(m_mul(d_u, zeta_inv_pows), scalar(pow(zeta_inv, u * n, R)))
        chunks.append(c_u)
    return chunks
