# Copy of halo2_snark_aggregator_tpu/protocol/pinned_compat.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""halo2-compatible pinned-vk digest (interop mode).

The reference binds every verification transcript to the verifying key by
absorbing a blake2b-512 digest of Rust's ``{:?}`` rendering of
``vk.pinned()`` (halo2-snark-aggregator-api/src/systems/halo2/verify.rs:56-72,
personalization ``Halo2-Verify-Key``, u64-LE length prefix).  Our default
``VerifyingKey.transcript_repr`` hashes an equally injective but *different*
serialization, so challenge sequences diverge from the Rust toolchain's.

This module reconstructs the reference's pinned-vk string byte-for-byte *to
the best knowledge available in this environment*.  The target is the exact
dependency set pinned by the reference's Cargo.lock:

  - halo2_proofs 0.2.0, scroll-tech/halo2 branch scroll-dev-0902/-1220
    (zcash/PSE lineage): ``PinnedVerificationKey``/``PinnedConstraintSystem``/
    ``PinnedEvaluationDomain`` in plonk.rs + plonk/circuit.rs, all
    ``#[derive(Debug)]`` structs rendered non-alternate.
  - halo2curves 0.2.1 (PSE tag): field elements Debug as ``0x`` + 64
    lowercase big-endian hex of the canonical repr; affine points Debug as
    ``(x, y)`` tuples (curve macro), identity as ``Infinity``.

Reproduced grammar (field order is the struct declaration order, derived
Debug prints ``Name { f1: v1, f2: v2 }`` / lists ``[a, b]`` / tuples
``(a, b)`` / ``Some(x)``/``None`` / unit structs as their name):

  PinnedVerificationKey { base_modulus: "…", scalar_modulus: "…",
    domain: PinnedEvaluationDomain { k: …, extended_k: …, omega: 0x… },
    cs: PinnedConstraintSystem { num_fixed_columns: …, num_advice_columns: …,
      num_instance_columns: …, num_selectors: …, gates: [Expression…],
      advice_queries: [(Column { index: …, column_type: Advice },
      Rotation(…)), …], instance_queries: […], fixed_queries: […],
      permutation: Argument { columns: […] }, lookups: [Argument {
      input_expressions: […], table_expressions: […] }, …], constants: […],
      minimum_degree: … },
    fixed_commitments: [(0x…, 0x…), …],
    permutation: VerifyingKey { commitments: […] } }

Known uncertainties, confined to this module (no Rust toolchain or vendored
halo2 exists here to diff against — tests/test_parity_fixtures.py documents
the fixture strategy):

  - multi-phase extensions: scroll's fork added challenges/phases in late
    2022; whether its pinned() Debug gained ``num_challenges``-style fields
    is unverifiable here.  We emit the 0.2.0 baseline layout; circuits that
    actually use challenges additionally render ``Challenge(Challenge {
    index: …, phase: Phase(…) })`` expressions (upstream's eventual shape).
  - affine-point style: halo2curves' curve macro tuple form ``(x, y)``.

Everything else in the transcript protocol already matches the reference
byte protocols (transcript/host.py), so any residual digest divergence is
fixable by editing only this file.
"""

from __future__ import annotations

from ..ff import bn254 as ff
from .plonk import ADVICE, FIXED, INSTANCE, Expression

# halo2curves 0.2.1 bn256 modulus strings (fq.rs / fr.rs `MODULUS`)
BASE_MODULUS = "0x30644e72e131a029b85045b68181585d97816a916871ca8d3c208c16d87cfd47"
SCALAR_MODULUS = "0x30644e72e131a029b85045b68181585d2833e84879b9709143e1f593f0000001"


def _fr(v: int) -> str:
    """Field-element Debug: 0x + 64 lowercase hex of the canonical value."""
    return "0x" + format(v % ff.R, "064x")


def _fq(v: int) -> str:
    return "0x" + format(v % ff.P, "064x")


def _point(pt) -> str:
    """Affine G1 Debug (halo2curves curve macro): (x, y) or Infinity."""
    if pt is None:
        return "Infinity"
    return f"({_fq(pt[0])}, {_fq(pt[1])})"


def _column(index: int, kind: str) -> str:
    ctype = {FIXED: "Fixed", ADVICE: "Advice", INSTANCE: "Instance"}[kind]
    return f"Column {{ index: {index}, column_type: {ctype} }}"


def _queries(queries, kind: str) -> str:
    return ("[" + ", ".join(
        f"({_column(ci, kind)}, Rotation({rot}))" for ci, rot in queries
    ) + "]")


def _expr(e: Expression, cs) -> str:
    k = e.kind
    if k == Expression.KIND_CONST:
        return f"Constant({_fr(e.value)})"
    if k == Expression.KIND_FIXED:
        ci, rot = cs.fixed_queries[e.value]
        return (f"Fixed {{ query_index: {e.value}, column_index: {ci}, "
                f"rotation: Rotation({rot}) }}")
    if k == Expression.KIND_ADVICE:
        ci, rot = cs.advice_queries[e.value]
        return (f"Advice {{ query_index: {e.value}, column_index: {ci}, "
                f"rotation: Rotation({rot}) }}")
    if k == Expression.KIND_INSTANCE:
        ci, rot = cs.instance_queries[e.value]
        return (f"Instance {{ query_index: {e.value}, column_index: {ci}, "
                f"rotation: Rotation({rot}) }}")
    if k == Expression.KIND_CHALLENGE:
        phase = cs.challenge_phase[e.value]
        return (f"Challenge(Challenge {{ index: {e.value}, "
                f"phase: Phase({phase}) }})")
    if k == Expression.KIND_NEG:
        return f"Negated({_expr(e.a, cs)})"
    if k == Expression.KIND_SUM:
        return f"Sum({_expr(e.a, cs)}, {_expr(e.b, cs)})"
    if k == Expression.KIND_PROD:
        return f"Product({_expr(e.a, cs)}, {_expr(e.b, cs)})"
    if k == Expression.KIND_SCALED:
        return f"Scaled({_expr(e.a, cs)}, {_fr(e.value)})"
    raise ValueError(k)


def _extended_k(k: int, degree: int) -> int:
    """EvaluationDomain::new(j=cs.degree(), k): smallest e >= k with
    2^e >= 2^k * (j - 1) (poly/domain.rs)."""
    n = 1 << k
    quotient_poly_degree = degree - 1
    e = k
    while (1 << e) < n * quotient_poly_degree:
        e += 1
    return e


def pinned_vk_debug_str(vk) -> str:
    """Render ``format!("{:?}", vk.pinned())`` for this VerifyingKey."""
    from ..prover.domain import omega_for_k

    cs = vk.cs
    gates = "[" + ", ".join(
        _expr(p, cs) for _, polys in cs.gates for p in polys
    ) + "]"
    lookups = "[" + ", ".join(
        "Argument { input_expressions: ["
        + ", ".join(_expr(e, cs) for e in lk.input_expressions)
        + "], table_expressions: ["
        + ", ".join(_expr(e, cs) for e in lk.table_expressions)
        + "] }"
        for lk in cs.lookups
    ) + "]"
    perm_columns = "[" + ", ".join(
        _column(c.index, c.kind) for c in cs.permutation_columns
    ) + "]"
    min_deg = ("None" if cs.minimum_degree is None
               else f"Some({cs.minimum_degree})")
    # multi-phase forks print the challenge/phase fields only when challenges
    # exist, keeping phase-0-only circuits' digests identical to 0.2.0's (and
    # keeping this serialization injective in the challenge fields)
    challenge_fields = ""
    if cs.num_challenges > 0:
        aph = "[" + ", ".join(f"Phase({p})" for p in cs.advice_column_phase) + "]"
        cph = "[" + ", ".join(f"Phase({p})" for p in cs.challenge_phase) + "]"
        challenge_fields = (
            f"num_challenges: {cs.num_challenges}, "
            f"advice_column_phase: {aph}, "
            f"challenge_phase: {cph}, "
        )
    domain = (f"PinnedEvaluationDomain {{ k: {vk.k}, "
              f"extended_k: {_extended_k(vk.k, cs.degree())}, "
              f"omega: {_fr(omega_for_k(vk.k))} }}")
    pinned_cs = (
        "PinnedConstraintSystem { "
        f"num_fixed_columns: {cs.num_fixed_columns}, "
        f"num_advice_columns: {cs.num_advice_columns}, "
        f"num_instance_columns: {cs.num_instance_columns}, "
        "num_selectors: 0, "
        f"{challenge_fields}"
        f"gates: {gates}, "
        f"advice_queries: {_queries(cs.advice_queries, ADVICE)}, "
        f"instance_queries: {_queries(cs.instance_queries, INSTANCE)}, "
        f"fixed_queries: {_queries(cs.fixed_queries, FIXED)}, "
        f"permutation: Argument {{ columns: {perm_columns} }}, "
        f"lookups: {lookups}, "
        "constants: [], "
        f"minimum_degree: {min_deg} }}"
    )
    fixed_c = "[" + ", ".join(_point(p) for p in vk.fixed_commitments) + "]"
    perm_c = "[" + ", ".join(_point(p) for p in vk.permutation_commitments) + "]"
    return (
        "PinnedVerificationKey { "
        f'base_modulus: "{BASE_MODULUS}", '
        f'scalar_modulus: "{SCALAR_MODULUS}", '
        f"domain: {domain}, "
        f"cs: {pinned_cs}, "
        f"fixed_commitments: {fixed_c}, "
        f"permutation: VerifyingKey {{ commitments: {perm_c} }} }}"
    )


def transcript_repr_compat(vk) -> int:
    """The reference's init_transcript digest (verify.rs:56-72) over the
    reconstructed pinned string: blake2b-512, personal ``Halo2-Verify-Key``,
    u64-LE length prefix, result mapped into Fr via from_bytes_wide."""
    import hashlib

    s = pinned_vk_debug_str(vk).encode()
    h = hashlib.blake2b(digest_size=64, person=b"Halo2-Verify-Key")
    h.update(len(s).to_bytes(8, "little"))
    h.update(s)
    return ff.fe_from_bytes_wide(h.digest(), ff.R)
