# Copy of halo2_snark_aggregator_tpu/solidity/linear_scan.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""Linear-scan memory allocation for the generated verifier (reference D3,
-solidity/src/code_generator/linear_scan/*): computes live intervals of SSA
values over the statement list and maps them onto a reusable slot pool, so
the contract's scratch memory stays small regardless of circuit size."""

from __future__ import annotations

from .ir import CodegenContext, Expr


def live_intervals(cg: CodegenContext) -> dict[int, tuple[int, int]]:
    """ssa id -> (def_index, last_use_index)."""
    intervals: dict[int, tuple[int, int]] = {}
    for i, st in enumerate(cg.statements):
        for d in st.dest:
            intervals[d] = (i, i)
        for a in st.args:
            if a.kind == "var":
                lo, _ = intervals[a.value]
                intervals[a.value] = (lo, i)
    return intervals


def allocate_slots(cg: CodegenContext, keep_live: list[int] = ()) -> tuple[dict[int, int], int]:
    """Returns (ssa id -> slot, total_slots). `keep_live` ids (the outputs)
    stay allocated to the end. Point ids are independent single slots (each
    coordinate is one word)."""
    intervals = live_intervals(cg)
    end = len(cg.statements)
    for k in keep_live:
        lo, _ = intervals[k]
        intervals[k] = (lo, end)

    free: list[int] = []
    total = 0
    slot_of: dict[int, int] = {}
    # expiry list per index
    expiring: dict[int, list[int]] = {}
    for ssa, (_lo, hi) in intervals.items():
        expiring.setdefault(hi, []).append(ssa)

    for i, st in enumerate(cg.statements):
        for d in st.dest:
            if free:
                slot_of[d] = free.pop()
            else:
                slot_of[d] = total
                total += 1
        # release values whose last use is this statement
        for ssa in expiring.get(i, []):
            if ssa in slot_of and intervals[ssa][1] == i:
                free.append(slot_of[ssa])
    return slot_of, total
