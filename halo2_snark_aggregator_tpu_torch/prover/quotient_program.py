"""Compile the quotient's expressions into one row program (ops/field
`RowProgram`), run once per coset shard by the row-program kernel.

`compile_quotient` emits the folds of prover/accel._compute_h_sharded, in
its order: per proof, every gate polynomial, the permutation's expressions
and the lookups' expressions, each folded as acc = acc * y + e. It calls
`Expression.evaluate` with handlers that emit instructions instead of
computing; a rotated column is a column reference at that rotation (the
shard's roll by -rot). Columns are named by keys, in first-use order:

    ("fixed", col), ("sigma", col), ("advice", proof, col),
    ("instance", proof, col), ("perm_z", proof, set),
    ("lookup_z" | "lookup_a" | "lookup_s", proof, lookup),
    ("l0",), ("l_last",), ("l_blind",), ("x",)

the coefficient columns whose coset extensions the program reads (the
three indicator polynomials and the polynomial X included). The shard's
vanishing-constant product and its INTT stay outside the program.

Slots are allocated by liveness: a value's slot is free after its last
read, and an instruction's result may take the slot of an operand it reads
last. A program that needs more than `max_slots` raises; it is not split.
"""

from __future__ import annotations

import heapq

from ..ff.bn254 import FR_DELTA, R
from ..ops import field as fo

# a value while compiling: ("v", virtual register), ("c", column reference)
# or ("k", constant)


class ProgramBuilder:
    """Emits three-address Fr instructions over virtual registers, then
    allocates slots (`finish`)."""

    def __init__(self):
        self.code: list = []               # (op, dst register, a, b)
        self.consts: dict[int, int] = {}   # value -> constant index
        self.columns: dict = {}            # key -> column index
        self._keys: list = []
        self.refs: dict = {}               # (column, rotation) -> ref index
        self._ref_list: list = []
        self._regs = 0

    def const(self, v: int):
        v %= R
        return ("k", self.consts.setdefault(v, len(self.consts)))

    def column(self, key: tuple, rot: int = 0):
        if key not in self.columns:
            self.columns[key] = len(self._keys)
            self._keys.append(key)
        c = self.columns[key]
        if (c, rot) not in self.refs:
            self.refs[(c, rot)] = len(self._ref_list)
            self._ref_list.append((c, rot))
        return ("c", self.refs[(c, rot)])

    def roll(self, val, rot: int):
        """`val` (an unrotated column) at rotation `rot`."""
        if val[0] != "c" or self._ref_list[val[1]][1] != 0:
            raise ValueError("only an unrotated column can be rotated")
        return self.column(self._keys[self._ref_list[val[1]][0]], rot)

    def _emit(self, op: int, a, b):
        reg = self._regs
        self._regs += 1
        self.code.append((op, reg, a, b))
        return ("v", reg)

    def mul(self, a, b):
        return self._emit(fo.MUL, a, b)

    def add(self, a, b):
        return self._emit(fo.ADD, a, b)

    def sub(self, a, b):
        return self._emit(fo.SUB, a, b)

    def neg(self, a):
        return self.sub(self.const(0), a)

    def finish(self, out, max_slots: int = fo.PROGRAM_SLOTS):
        """(RowProgram, column keys in column order)."""
        if max_slots > fo.PROGRAM_SLOTS:
            raise ValueError(f"at most {fo.PROGRAM_SLOTS} slots")
        last: dict[int, int] = {}
        for i, (_op, _d, a, b) in enumerate(self.code):
            for o in (a, b):
                if o[0] == "v":
                    last[o[1]] = i
        if out[0] == "v":
            last[out[1]] = len(self.code)
        free = list(range(max_slots))
        slot: dict[int, int] = {}
        code = []
        for i, (op, dst, a, b) in enumerate(self.code):
            enc = [self._encode(o, slot) for o in (a, b)]
            for reg in {o[1] for o in (a, b) if o[0] == "v"}:
                if last[reg] == i:
                    heapq.heappush(free, slot[reg])
            if not free:
                raise ValueError(f"row program needs more than {max_slots} "
                                 f"slots (instruction {i} of {len(self.code)})")
            slot[dst] = heapq.heappop(free)
            if dst not in last:  # never read: free at once
                heapq.heappush(free, slot[dst])
            code.append((op, slot[dst], *enc))
        consts = [fo.FR.to_mont_int(v) for v in self.consts]  # index order
        prog = fo.RowProgram(code=code, refs=self._ref_list,
                             consts=fo.ints_to_words(consts),
                             n_cols=len(self._keys),
                             out=self._encode(out, slot))
        return prog, list(self._keys)

    @staticmethod
    def _encode(o, slot) -> int:
        kind = {"v": fo.SLOT, "c": fo.COLUMN, "k": fo.CONST}[o[0]]
        return fo.operand(kind, slot[o[1]] if o[0] == "v" else o[1])


def compile_quotient(cs, num_proofs: int, challenges: list[int], theta: int,
                     beta: int, gamma: int, y: int,
                     max_slots: int = fo.PROGRAM_SLOTS):
    """The quotient numerator of `num_proofs` proofs of one circuit as a row
    program over the shard's extended columns: (RowProgram, column keys).
    The folds are those of prover/accel._compute_h_sharded, in its order."""
    b = ProgramBuilder()
    bf = cs.blinding_factors()
    chunk_len = cs.permutation_chunk_len()
    perm_cols = cs.permutation_columns
    n_sets = -(-len(perm_cols) // chunk_len) if perm_cols else 0
    y_k, theta_k = b.const(y), b.const(theta)
    beta_k, gamma_k, one_k = b.const(beta), b.const(gamma), b.const(1)
    state: dict = {"acc": None, "active": None}

    def fold(e) -> None:
        acc = state["acc"]
        state["acc"] = e if acc is None else b.add(b.mul(acc, y_k), e)

    def active():
        """1 - (l_last + l_blind), emitted at its first use."""
        if state["active"] is None:
            state["active"] = b.sub(one_k, b.add(b.column(("l_last",)),
                                                  b.column(("l_blind",))))
        return state["active"]

    def compress(exprs, expr):
        """sum e_j theta^(m-1-j), folded like `acc = acc * theta + e`."""
        out = None
        for e in exprs:
            v = expr(e)
            out = v if out is None else b.add(b.mul(out, theta_k), v)
        return b.const(0) if out is None else out

    def query_column(kind: str, p: int, q: int):
        queries = {"fixed": cs.fixed_queries, "advice": cs.advice_queries,
                   "instance": cs.instance_queries}[kind]
        col, rot = queries[q]
        key = ("fixed", col) if kind == "fixed" else (kind, p, col)
        return b.column(key, rot)

    def l0():
        return b.column(("l0",))

    def l_last():
        return b.column(("l_last",))

    for p in range(num_proofs):
        def expr(e, p=p):
            return e.evaluate(
                constant=b.const,
                fixed=lambda q: query_column("fixed", p, q),
                advice=lambda q: query_column("advice", p, q),
                instance=lambda q: query_column("instance", p, q),
                challenge=lambda i: b.const(challenges[i]),
                neg=b.neg, add=b.add, mul=b.mul,
                scale=lambda a, sc: b.mul(a, b.const(sc)))

        # gates
        for _, polys in cs.gates:
            for g in polys:
                fold(expr(g))

        # permutation expressions
        if n_sets:
            z = [b.column(("perm_z", p, s)) for s in range(n_sets)]
            fold(b.mul(l0(), b.sub(one_k, z[0])))
            zl = z[-1]
            fold(b.mul(l_last(), b.sub(b.mul(zl, zl), zl)))
            for s in range(1, n_sets):
                prev = b.roll(z[s - 1], -(bf + 1))
                fold(b.mul(b.sub(z[s], prev), l0()))
            x = b.column(("x",))
            for set_idx, start in enumerate(range(0, len(perm_cols), chunk_len)):
                left, right = b.roll(z[set_idx], 1), z[set_idx]
                delta_pow = pow(FR_DELTA, set_idx * chunk_len, R)
                for j, col in enumerate(perm_cols[start : start + chunk_len]):
                    qidx = cs.get_any_query_index(col, 0)
                    if col.kind == "advice":
                        vp = b.column(("advice", p, cs.advice_queries[qidx][0]))
                    elif col.kind == "fixed":
                        vp = b.column(("fixed", cs.fixed_queries[qidx][0]))
                    else:
                        vp = b.column(("instance", p,
                                       cs.instance_queries[qidx][0]))
                    sigma = b.column(("sigma", start + j))
                    left = b.mul(left, b.add(vp, b.add(b.mul(beta_k, sigma),
                                                       gamma_k)))
                    dx = b.mul(x, b.const(beta * delta_pow % R))
                    right = b.mul(right, b.add(vp, b.add(dx, gamma_k)))
                    delta_pow = delta_pow * FR_DELTA % R
                fold(b.mul(b.sub(left, right), active()))

        # lookup expressions
        for lk, arg in enumerate(cs.lookups):
            zc = b.column(("lookup_z", p, lk))
            ac = b.column(("lookup_a", p, lk))
            sc = b.column(("lookup_s", p, lk))
            z_next, a_prev = b.roll(zc, 1), b.roll(ac, -1)
            input_e = compress(arg.input_expressions, expr)
            table_e = compress(arg.table_expressions, expr)
            fold(b.mul(l0(), b.sub(one_k, zc)))
            fold(b.mul(l_last(), b.sub(b.mul(zc, zc), zc)))
            left = b.mul(z_next, b.mul(b.add(ac, beta_k), b.add(sc, gamma_k)))
            right = b.mul(zc, b.mul(b.add(input_e, beta_k),
                                    b.add(table_e, gamma_k)))
            fold(b.mul(b.sub(left, right), active()))
            a_minus_s = b.sub(ac, sc)
            fold(b.mul(l0(), a_minus_s))
            fold(b.mul(b.mul(a_minus_s, b.sub(ac, a_prev)), active()))

    acc = state["acc"]
    return b.finish(b.const(0) if acc is None else acc, max_slots)


def compile_fold(n_cols: int, v: int):
    """sum_j col_j v^(n_cols - 1 - j) as a row program over columns 0 ..
    n_cols - 1, by Horner: acc = acc * v + col_j (the opening's combination
    of the polynomials of one rotation set)."""
    b = ProgramBuilder()
    acc = None
    for j in range(n_cols):
        c = b.column(j)
        acc = c if acc is None else b.add(b.mul(acc, b.const(v)), c)
    return b.finish(acc)[0]


def compile_perm_products(deltas: list[int], beta: int, gamma: int):
    """The permutation argument's two grand-product factors of one set of
    columns v_j: num = prod_j (v_j + beta delta_j omega^i + gamma) and den =
    prod_j (v_j + beta sigma_j + gamma), as two row programs over the
    columns ("v", j), ("sigma", j) and ("omega",) (the powers omega^i):
    [(num program, its keys), (den program, its keys)]."""
    out = []
    for numerator in (True, False):
        b = ProgramBuilder()
        beta_k, gamma_k = b.const(beta), b.const(gamma)
        acc = None
        for j, delta in enumerate(deltas):
            t = (b.mul(b.column(("omega",)), b.const(delta)) if numerator
                 else b.column(("sigma", j)))
            term = b.add(b.column(("v", j)), b.add(b.mul(beta_k, t), gamma_k))
            acc = term if acc is None else b.mul(acc, term)
        out.append(b.finish(acc))
    return out
