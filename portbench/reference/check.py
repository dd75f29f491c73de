"""The plain reference that decides `correct` for the zkevm-shape cells.

Plain Python over the frozen copies in this folder; it imports nothing of
the program under test and takes nothing the program made:

  * the constraint system is this folder's copy of the circuit's
    `configure`;
  * the key's commitments are the committed `keys/<fingerprint>.json`,
    accepted only when this folder's own `transcript_repr` over them and
    that constraint system hashes to the fingerprint the fixtures pin;
  * the SRS points the verifier needs (the Lagrange prefix, [tau] G2) come
    from the configuration's unsafe-setup seed: tau is public there;
  * proofs and instances are the committed fixtures, or for proofs the
    program made, the instance this folder's circuit copy derives from the
    circuit seed.

`verify_proof` is one proof through the value-context verifier: its
opening pair (w_x, w_g), its final squeeze and its pairing verdict.
`aggregate` folds such per-proof results over a batch's lanes exactly as
batched aggregation defines it: the aggregation transcript absorbs every
lane's final squeeze, lambda is its squeeze, lane b weighs lambda^(B-1-b),
and the verdict is one pairing check of the folded pair. `verify_many`
and `aggregate_many` run them over worker processes of their own, each
started fresh (spawn) and ended before they return.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import json
import multiprocessing
import os
from pathlib import Path

from . import bn254 as ff
from . import verify as rv
from .domain import Domain
from .plonk import ConstraintSystem, VerifyingKey
from .poseidon_chip import PoseidonChipSponge
from .transcript import PoseidonTranscriptRead
from .value import ValueContext, ValueEccChip, ValueFieldChip
from .zkevm import ZkevmShapeCircuit

KEYS = Path(__file__).resolve().parent / "keys"


class CountingFieldChip(ValueFieldChip):
    """The value chip, counting Poseidon permutations."""

    def __init__(self):
        super().__init__()
        self.permutations = 0

    def poseidon_permute(self, ctx, state, inputs):
        self.permutations += 1
        return super().poseidon_permute(ctx, state, inputs)


@dataclasses.dataclass
class Params:
    """The SRS points a verifier reads: the Lagrange prefix, G2 and [tau] G2."""

    k: int
    n: int
    g_lagrange: list
    g2: tuple
    s_g2: tuple


def params(k: int, srs_seed: str, lagrange: int) -> Params:
    """The unsafe setup's tau from its seed (sha256(seed || k LE32) mod r),
    L_i(tau) G1 for i < lagrange, and [tau] G2."""
    digest = hashlib.sha256(srs_seed.encode() + k.to_bytes(4, "little"))
    tau = int.from_bytes(digest.digest(), "little") % ff.R
    n = 1 << k
    omega = Domain(k).omega
    tau_n = pow(tau, n, ff.R)
    n_inv = pow(n, -1, ff.R)
    lag, w = [], 1
    for _ in range(lagrange):
        li = w * n_inv % ff.R * (tau_n - 1) % ff.R * pow(tau - w, -1, ff.R) % ff.R
        lag.append(ff.g1_mul(ff.G1_GEN, li))
        w = w * omega % ff.R
    return Params(k, n, lag, ff.G2_GEN, ff.g2_mul(ff.G2_GEN, tau))


def fingerprint(vk: VerifyingKey) -> str:
    return hashlib.sha256(str(vk.transcript_repr()).encode()).hexdigest()[:16]


def _point(p):
    return None if p is None else (int(p[0]), int(p[1]))


def load_key(k: int, n_groups: int, want: str) -> VerifyingKey:
    """The key of ZkevmShapeCircuit(k, n_groups): this folder's constraint
    system, the committed commitments; raises unless its fingerprint is
    `want`."""
    cs = ConstraintSystem()
    ZkevmShapeCircuit(k=k, seed=1, n_groups=n_groups).configure(cs)
    with open(KEYS / f"{want}.json") as f:
        data = json.load(f)
    vk = VerifyingKey(k=k, cs=cs,
                      fixed_commitments=[_point(p) for p in data["fixed"]],
                      permutation_commitments=[_point(p) for p in data["permutation"]])
    got = fingerprint(vk)
    if got != want:
        raise ValueError(f"reference key fingerprint {got} != {want}")
    return vk


def instances(k: int, n_groups: int, seed: int) -> list[list[int]]:
    """The public instance of ZkevmShapeCircuit(k, seed, n_groups)."""
    return ZkevmShapeCircuit(k=k, seed=seed, n_groups=n_groups).instances()


@dataclasses.dataclass
class ProofResult:
    w_x: object       # affine point or None
    w_g: object
    squeeze: int      # the transcript's final squeeze, for aggregation
    ok: bool          # pairing verdict, the whole proof read
    permutations: int  # Poseidon permutations of the transcript and squeeze


def verify_proof(vk, prm: Params, proof: bytes, inst: list) -> ProofResult:
    """One proof through the value-context verifier. A proof that cannot be
    parsed (a point off the curve, a scalar out of range, too few bytes)
    reads as a failed verdict."""
    ctx, sc, pc = ValueContext(), CountingFieldChip(), ValueEccChip()
    try:
        _plain, commits = rv.assign_instance_commitment(ctx, sc, pc, [inst],
                                                        vk, prm)
        tr = PoseidonTranscriptRead(proof, ctx, sc)
        ast, _adv = rv.verify_single_proof_no_eval(ctx, sc, sc, pc, commits,
                                                   vk, prm, tr, "")
        w_x, w_g, ok = rv.evaluate_multiopen_proof(ctx, sc, pc, ast, prm)
        squeeze = tr.squeeze_challenge_scalar(ctx, sc, sc)
    except (ValueError, EOFError, AssertionError, TypeError):
        return ProofResult(None, None, 0, False, sc.permutations)
    return ProofResult(w_x, w_g, squeeze, bool(ok) and tr.at_end(),
                       sc.permutations)


def aggregate(results: list, lanes: list, prm: Params):
    """(w_x, w_g, verdict) of a batch whose lane b holds proof lanes[b],
    from each proof's `ProofResult`."""
    ctx, chip = ValueContext(), ValueFieldChip()
    sponge = PoseidonChipSponge(chip, ctx)
    sponge.update([results[p].squeeze for p in lanes])
    lam = sponge.squeeze(ctx)
    weight: dict[int, int] = {}
    b_last = len(lanes) - 1
    for b, p in enumerate(lanes):
        weight[p] = (weight.get(p, 0) + pow(lam, b_last - b, ff.R)) % ff.R
    order = sorted(weight)
    coeffs = [weight[p] for p in order]
    w_x = ff.g1_msm([results[p].w_x for p in order], coeffs)
    w_g = ff.g1_msm([results[p].w_g for p in order], coeffs)
    ok = ff.pairing_check([(w_x, prm.s_g2), (w_g, ff.g2_neg(prm.g2))])
    return w_x, w_g, bool(ok)


# -- over worker processes -------------------------------------------------

_WORKER: dict = {}


def workers() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def _pool(n_tasks: int, initializer=None, initargs=()):
    return concurrent.futures.ProcessPoolExecutor(
        max_workers=max(1, min(workers(), n_tasks)),
        mp_context=multiprocessing.get_context("spawn"),
        initializer=initializer, initargs=initargs)


def _init_verify(k, n_groups, fp, prm):
    _WORKER["vk"] = load_key(k, n_groups, fp)
    _WORKER["prm"] = prm


def _verify_one(item):
    proof, inst = item
    return verify_proof(_WORKER["vk"], _WORKER["prm"], proof, inst)


def verify_many(k: int, n_groups: int, fp: str, prm: Params,
                items: list) -> list:
    """`verify_proof` of each (proof, instances) of `items`, in order."""
    if len(items) <= 1:
        vk = load_key(k, n_groups, fp)
        return [verify_proof(vk, prm, p, inst) for p, inst in items]
    with _pool(len(items), _init_verify, (k, n_groups, fp, prm)) as ex:
        return list(ex.map(_verify_one, items))


def _aggregate_one(item):
    results, lanes, prm = item
    return aggregate(results, lanes, prm)


def aggregate_many(results: list, batches: list, prm: Params) -> list:
    """`aggregate` of each batch's lanes, in order."""
    items = [({p: results[p] for p in set(lanes)}, lanes, prm)
             for lanes in batches]
    if len(items) <= 1:
        return [_aggregate_one(it) for it in items]
    with _pool(len(items)) as ex:
        return list(ex.map(_aggregate_one, items))
