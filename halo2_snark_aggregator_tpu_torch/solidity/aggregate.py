# Copy of halo2_snark_aggregator_tpu/solidity/aggregate.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""Group optimizers (reference D5, -solidity/src/code_generator/
linear_scan/aggregate.rs + subpasses): recognize repetitive statement shapes
and collapse them into packed loop statements, shrinking both contract
bytecode and calldata-processing gas:

  * `merge_hash_runs`    — UpdateHashMerger: runs of consecutive transcript
    absorptions over contiguous proof words -> `hash_points_run` /
    `hash_scalars_run` loops (aggregate/update_hash.rs);
  * `pack_horner`        — MulAddPMOptimizer analog: Horner chains
    acc = acc*v + proof[t_i] with <=16 16-bit proof offsets packed into one
    word -> `fr_horner_pm` (multi_mul_add_pm.rs, CAP=16);
  * `pack_dot`           — MulAddMTOptimizer analog: dot chains
    acc += m_i * proof[t_i] -> `fr_dot_mt`; memory slots are packed by the
    renderer after linear-scan allocation (multi_mul_add_mt.rs);
  * `pack_sqr_chains`    — AggregateFrPowOptimizer analog: repeated-squaring
    chains -> `fr_sqr_chain` loops (aggregate_fr_pow.rs).

  * `pack_ecc_runs`      — AggregateMulSeqOptimizer analog: runs of
    consecutive-transcript-point `ecc_mul`+`ecc_add` accumulator folds ->
    one `ecc_dot_pm` loop (aggregate_mul_seq.rs ForMMMMul; the multiopen
    W folds produce these runs).

Passes run on the SSA statement list BEFORE slot allocation: eliminated
intermediate values simply never receive slots, and live intervals are
computed over the packed list (the reference runs its pipeline after memory
substitution; SSA-first is equivalent and keeps the liveness analysis in one
place).
"""

from __future__ import annotations

from .ir import CodegenContext, Expr, Statement

PM_CAP = 16  # 16 x 16-bit packed offsets per word (reference CAP=16)
MT_CAP = 16  # (reference packs 32 x 8-bit; we keep 16-bit offsets)
MIN_RUN = 2


def _use_counts(statements) -> dict[int, int]:
    uses: dict[int, int] = {}
    for st in statements:
        for a in st.args:
            if a.kind == "var":
                uses[a.value] = uses.get(a.value, 0) + 1
    return uses


def _pack16(offsets: list[int]) -> int:
    word = 0
    for i, off in enumerate(offsets):
        assert 0 <= off < (1 << 16)
        word |= off << (16 * i)
    return word


def merge_hash_runs(statements: list[Statement]) -> list[Statement]:
    out: list[Statement] = []
    i = 0
    n = len(statements)
    while i < n:
        st = statements[i]
        if st.op in ("hash_point", "hash_scalar") and all(
                a.kind == "transcript" for a in st.args):
            width = 2 if st.op == "hash_point" else 1
            start = st.args[0].value
            j = i
            nxt_word = start
            while (j < n and statements[j].op == st.op
                   and all(a.kind == "transcript" for a in statements[j].args)
                   and statements[j].args[0].value == nxt_word
                   and (width == 1 or statements[j].args[1].value == nxt_word + 1)):
                nxt_word += width
                j += 1
            count = j - i
            if count >= MIN_RUN:
                op = "hash_points_run" if width == 2 else "hash_scalars_run"
                out.append(Statement(op, (), (Expr("const", start),
                                              Expr("const", count))))
                i = j
                continue
        out.append(st)
        i += 1
    return out


def pack_sqr_chains(statements: list[Statement]) -> list[Statement]:
    uses = _use_counts(statements)
    out: list[Statement] = []
    i = 0
    n = len(statements)
    while i < n:
        st = statements[i]
        if st.op == "fr_mul" and st.args[0] == st.args[1]:
            j = i
            cur = st
            while True:
                nxt = statements[j + 1] if j + 1 < n else None
                prev_d = Expr("var", cur.dest[0])
                if (nxt is not None and nxt.op == "fr_mul"
                        and nxt.args[0] == prev_d and nxt.args[1] == prev_d
                        and uses.get(cur.dest[0], 0) == 1):
                    j += 1
                    cur = statements[j]
                else:
                    break
            count = j - i + 1
            if count >= MIN_RUN:
                out.append(Statement("fr_sqr_chain", cur.dest,
                                     (st.args[0], Expr("const", count))))
                i = j + 1
                continue
        out.append(st)
        i += 1
    return out


def pack_horner(statements: list[Statement]) -> list[Statement]:
    """acc_{i+1} = acc_i * v + proof[t_i] chains -> fr_horner_pm."""
    uses = _use_counts(statements)

    def step(st, prev_dest):
        """Returns (v_expr, t_offset) if st continues a chain through
        prev_dest, else None."""
        if st.op != "fr_mul_add" or st.args[2].kind != "transcript":
            return None
        a, b, w = st.args
        if prev_dest is not None:
            pd = Expr("var", prev_dest)
            if a == pd:
                return b, w.value
            if b == pd:
                return a, w.value
            return None
        return None

    out: list[Statement] = []
    i = 0
    n = len(statements)
    while i < n:
        st = statements[i]
        # chain start: fr_mul_add with transcript addend
        if st.op == "fr_mul_add" and st.args[2].kind == "transcript":
            a0, b0, w0 = st.args
            # try both (acc0, v) assignments; prefer the one that chains
            for acc0, v in ((a0, b0), (b0, a0)):
                offs = [w0.value]
                j = i
                cur = st
                while j + 1 < n and len(offs) < PM_CAP:
                    s = step(statements[j + 1], cur.dest[0])
                    if s is None or s[0] != v or uses.get(cur.dest[0], 0) != 1:
                        break
                    offs.append(s[1])
                    j += 1
                    cur = statements[j]
                if len(offs) >= 3:
                    out.append(Statement(
                        "fr_horner_pm", cur.dest,
                        (acc0, v, Expr("const", _pack16(offs)),
                         Expr("const", len(offs)))))
                    i = j + 1
                    break
            else:
                out.append(st)
                i += 1
                continue
            continue
        out.append(st)
        i += 1
    return out


def pack_dot(statements: list[Statement]) -> list[Statement]:
    """acc_{i+1} = acc_i + m_i * proof[t_i] chains -> fr_dot_mt.
    Statement layout: dest=(d,), args=(acc0, const packed_t_offsets,
    const count, m_0, ..., m_{count-1}); the renderer packs the memory slot
    offsets after linear-scan allocation."""
    uses = _use_counts(statements)
    out: list[Statement] = []
    i = 0
    n = len(statements)
    while i < n:
        st = statements[i]
        if (st.op == "fr_mul_add" and st.args[1].kind == "transcript"
                and st.args[0].kind == "var"):
            acc0 = st.args[2]
            t_offs = [st.args[1].value]
            m_vars = [st.args[0]]
            j = i
            cur = st
            while j + 1 < n and len(t_offs) < MT_CAP:
                nxt = statements[j + 1]
                if (nxt.op == "fr_mul_add"
                        and nxt.args[1].kind == "transcript"
                        and nxt.args[0].kind == "var"
                        and nxt.args[2] == Expr("var", cur.dest[0])
                        and uses.get(cur.dest[0], 0) == 1):
                    t_offs.append(nxt.args[1].value)
                    m_vars.append(nxt.args[0])
                    j += 1
                    cur = statements[j]
                else:
                    break
            if len(t_offs) >= 3:
                out.append(Statement(
                    "fr_dot_mt", cur.dest,
                    (acc0, Expr("const", _pack16(t_offs)),
                     Expr("const", len(t_offs)), *m_vars)))
                i = j + 1
                continue
        out.append(st)
        i += 1
    return out


ECC_RUN_CAP = 16   # scalar slots per packed moffs word
ECC_RUN_MIN = 3


def pack_ecc_runs(statements: list[Statement]) -> list[Statement]:
    """AggregateMulSeqOptimizer analog (reference aggregate_mul_seq.rs:
    ForMMMMul): collapse runs of

        (tx, ty) = ecc_mul(proof[o], proof[o+1], m[s_i])
        (ax, ay) = ecc_add(ax, ay, tx, ty)

    with o advancing by exactly 2 per pair (consecutive transcript points —
    the multiopen W-commitment folds emit exactly this) into a single
    `ecc_dot_pm` loop statement. Scalars stay arbitrary memory slots and
    are packed into one 16x16-bit offset word at render time, like
    fr_dot_mt. Round 2 documented this optimizer away as moot; measuring a
    real verifier found 5+ eligible runs, so it exists now."""
    uses = _use_counts(statements)
    out: list[Statement] = []
    i = 0
    n = len(statements)
    while i < n:
        run: list[tuple[int, Statement, Statement]] = []
        acc0 = None
        j = i
        while j + 1 < n and len(run) < ECC_RUN_CAP:
            m_st, a_st = statements[j], statements[j + 1]
            if m_st.op != "ecc_mul" or a_st.op != "ecc_add":
                break
            px, py, sc = m_st.args
            if (px.kind != "transcript" or py.kind != "transcript"
                    or py.value != px.value + 1 or sc.kind != "var"):
                break
            if run and px.value != run[-1][0] + 2:
                break
            if (a_st.args[2].kind != "var"
                    or a_st.args[2].value != m_st.dest[0]
                    or a_st.args[3].kind != "var"
                    or a_st.args[3].value != m_st.dest[1]):
                break
            if run:
                prev_add = run[-1][2]
                if (a_st.args[0].kind != "var"
                        or a_st.args[0].value != prev_add.dest[0]
                        or a_st.args[1].kind != "var"
                        or a_st.args[1].value != prev_add.dest[1]):
                    break
                if (uses.get(prev_add.dest[0], 0) != 1
                        or uses.get(prev_add.dest[1], 0) != 1):
                    break
            if (uses.get(m_st.dest[0], 0) != 1
                    or uses.get(m_st.dest[1], 0) != 1):
                break
            if not run:
                acc0 = (a_st.args[0], a_st.args[1])
            run.append((px.value, m_st, a_st))
            j += 2
        if len(run) >= ECC_RUN_MIN:
            last_add = run[-1][2]
            scals = tuple(mst.args[2] for _o, mst, _a in run)
            out.append(Statement(
                "ecc_dot_pm", last_add.dest,
                (acc0[0], acc0[1], Expr("const", run[0][0]),
                 Expr("const", len(run))) + scals))
            i = j
        else:
            out.append(statements[i])
            i += 1
    return out


def optimize(cg: CodegenContext) -> dict[str, int]:
    """Run all group passes in place; returns per-pass statement savings."""
    stats = {}
    for name, fn in (("hash_runs", merge_hash_runs),
                     ("sqr_chains", pack_sqr_chains),
                     ("horner_pm", pack_horner),
                     ("dot_mt", pack_dot),
                     ("ecc_runs", pack_ecc_runs)):
        before = len(cg.statements)
        cg.statements = fn(cg.statements)
        stats[name] = before - len(cg.statements)
    return stats
