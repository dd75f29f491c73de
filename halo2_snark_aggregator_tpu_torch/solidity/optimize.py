# Copy of halo2_snark_aggregator_tpu/solidity/optimize.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""Peephole optimizer (reference D4, linear_scan/optimize.rs): fuses an
`fr_mul` whose single consumer is an immediately-following `fr_add`/`fr_sub`
into one `fr_mul_add` statement (rendered as one mulmod+addmod expression),
shrinking both statement count and live values."""

from __future__ import annotations

from .ir import CodegenContext, Expr, Statement


def _use_counts(cg: CodegenContext) -> dict[int, int]:
    uses: dict[int, int] = {}
    for st in cg.statements:
        for a in st.args:
            if a.kind == "var":
                uses[a.value] = uses.get(a.value, 0) + 1
    return uses


def combine_mul_add(cg: CodegenContext) -> int:
    """In-place fusion; returns the number of statements fused."""
    uses = _use_counts(cg)
    out: list[Statement] = []
    fused = 0
    i = 0
    sts = cg.statements
    while i < len(sts):
        st = sts[i]
        nxt = sts[i + 1] if i + 1 < len(sts) else None
        if (
            st.op == "fr_mul"
            and nxt is not None
            and nxt.op in ("fr_add", "fr_sub")
            and uses.get(st.dest[0], 0) == 1
            and any(a.kind == "var" and a.value == st.dest[0] for a in nxt.args)
        ):
            prod = Expr("var", st.dest[0])
            a, b = nxt.args
            if nxt.op == "fr_add":
                other = b if a == prod else a
                # dest = mul.args[0]*mul.args[1] + other
                out.append(Statement("fr_mul_add", nxt.dest, (*st.args, other)))
                fused += 1
                i += 2
                continue
            if nxt.op == "fr_sub" and a == prod:
                # dest = mul - other
                out.append(Statement("fr_mul_sub", nxt.dest, (*st.args, b)))
                fused += 1
                i += 2
                continue
        out.append(st)
        i += 1
    cg.statements = out
    return fused
