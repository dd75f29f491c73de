# Copy of halo2_snark_aggregator_tpu/solidity/ir.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""EVM verifier codegen IR (reference D2, -solidity/src/code_generator/ctx.rs).

Expressions reference: proof calldata words (transcript), instance calldata
words, SSA values, and constants. Statements are SSA assignments plus
transcript side effects. The running sha256 transcript state is implicit
(like the reference's `update_hash` statements + `Expression::Hash`): the
contract/interpreter maintains it across `hash_scalar`/`hash_point`/`squeeze`.

EC points are 2-word values: point-producing ops get a pair of SSA ids.
`linear_scan.py` later maps SSA ids onto a reusable memory pool (D3).
"""

from __future__ import annotations

import dataclasses
import itertools


@dataclasses.dataclass(frozen=True)
class Expr:
    kind: str  # const | transcript | instance | var
    value: object = None


@dataclasses.dataclass
class Statement:
    op: str        # fr_add fr_sub fr_mul fr_div | ecc_add ecc_mul |
                   # hash_scalar hash_point squeeze | assert_eq
    dest: tuple    # SSA ids written (possibly empty)
    args: tuple    # Expr operands


class CodegenContext:
    """Records statements with CSE + constant folding hooks (reference D1:
    SolidityFieldExpr folding, assign_memory cache)."""

    def __init__(self):
        self.statements: list[Statement] = []
        self._ids = itertools.count()
        self._cse: dict = {}
        self.transcript_words = 0
        self.instance_words = 0

    def const(self, v: int) -> Expr:
        return Expr("const", v)

    def transcript_word(self) -> Expr:
        e = Expr("transcript", self.transcript_words)
        self.transcript_words += 1
        return e

    def instance_word(self, index: int) -> Expr:
        self.instance_words = max(self.instance_words, index + 1)
        return Expr("instance", index)

    def emit(self, op: str, args: tuple, out_words: int = 1):
        key = (op, args)
        cached = self._cse.get(key)
        if cached is not None:
            return cached
        dest = tuple(next(self._ids) for _ in range(out_words))
        self.statements.append(Statement(op, dest, args))
        out = tuple(Expr("var", d) for d in dest)
        result = out[0] if out_words == 1 else out
        self._cse[key] = result
        return result

    def side_effect(self, op: str, args: tuple):
        self.statements.append(Statement(op, (), args))

    def squeeze(self) -> Expr:
        # squeezes depend on transcript state: never CSE'd
        dest = (next(self._ids),)
        self.statements.append(Statement("squeeze", dest, ()))
        return Expr("var", dest[0])
