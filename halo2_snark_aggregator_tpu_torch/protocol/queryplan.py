# Copy of halo2_snark_aggregator_tpu/protocol/queryplan.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""Shared multiopen query plan.

The GWC multiopen groups queries by rotation in *first-seen order* and folds
each group by v in push order (reference multiopen.rs:24-70). The prover must
construct its witness polynomials W_i with exactly the same grouping/order.
This module computes the symbolic ordered query list from the vk alone, so
prover and verifier cannot drift (SURVEY.md §3.1/3.3 call stacks; the
reference relies on halo2's prover and its own verifier agreeing implicitly —
see the 2020.10.14 note in multiopen.rs:46-49).

Each query is (rotation:int, poly_ref:tuple). poly_ref kinds:
  ("instance", proof, column)  ("advice", proof, column)
  ("perm_z", proof, set)       ("lookup_z"/"lookup_a"/"lookup_s", proof, idx)
  ("fixed", column)            ("sigma", idx)
  ("h",)                       ("random",)

Ordering mirrors params.rs:75-225 queries():
  per proof: instance queries, advice queries,
             permutation: (z_i, 0), (z_i, 1) for all sets, then sets except
             the last in *reversed index order* at rotation -(bf+1),
             lookups: (z,0), (a',0), (s',0), (a',-1), (z,1);
  then fixed queries, sigma queries, vanishing h (0), random (0).
"""

from __future__ import annotations

from .plonk import VerifyingKey


def query_plan(vk: VerifyingKey, num_proofs: int) -> list[tuple[int, tuple]]:
    cs = vk.cs
    bf = cs.blinding_factors()
    nsets = cs.permutation_num_chunks()
    queries: list[tuple[int, tuple]] = []
    for p in range(num_proofs):
        for (col, rot) in cs.instance_queries:
            queries.append((rot, ("instance", p, col)))
        for (col, rot) in cs.advice_queries:
            queries.append((rot, ("advice", p, col)))
        for s in range(nsets):
            queries.append((0, ("perm_z", p, s)))
            queries.append((1, ("perm_z", p, s)))
        for s in range(nsets - 2, -1, -1):
            queries.append((-(bf + 1), ("perm_z", p, s)))
        for lk in range(len(cs.lookups)):
            queries.append((0, ("lookup_z", p, lk)))
            queries.append((0, ("lookup_a", p, lk)))
            queries.append((0, ("lookup_s", p, lk)))
            queries.append((-1, ("lookup_a", p, lk)))
            queries.append((1, ("lookup_z", p, lk)))
    for (col, rot) in cs.fixed_queries:
        queries.append((rot, ("fixed", col)))
    for s in range(len(vk.permutation_commitments)):
        queries.append((0, ("sigma", s)))
    queries.append((0, ("h",)))
    queries.append((0, ("random",)))
    return queries


def rotation_sets(plan: list[tuple[int, tuple]]) -> list[tuple[int, list[tuple]]]:
    """Group by rotation, first-seen order. Returns [(rotation, [poly_ref...])]."""
    sets: list[tuple[int, list[tuple]]] = []
    for rot, ref in plan:
        for r, refs in sets:
            if r == rot:
                refs.append(ref)
                break
        else:
            sets.append((rot, [ref]))
    return sets
