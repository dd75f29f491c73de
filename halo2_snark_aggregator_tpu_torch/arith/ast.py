# Copy of halo2_snark_aggregator_tpu/arith/ast.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""Deferred-evaluation scalar AST over assigned field values.

Python counterpart of the reference's FieldArithHelper / `arith_ast!` macro
(arith/ast.rs:4-86): protocol formulas are written once as expression trees
over already-assigned values, then evaluated in whatever context the chip
provides. With Python operator overloading the macro becomes plain syntax:

    (l_0 * (one - z_x)).eval(ctx, schip)

Wrap assigned values with `V(...)`.
"""

from __future__ import annotations


class Ast:
    def __add__(self, o): return _Bin("add", self, _wrap(o))
    def __sub__(self, o): return _Bin("sub", self, _wrap(o))
    def __mul__(self, o): return _Bin("mul", self, _wrap(o))
    def __truediv__(self, o): return _Bin("div", self, _wrap(o))

    def eval(self, ctx, schip):
        raise NotImplementedError


class V(Ast):
    """Leaf: an already-assigned value."""

    def __init__(self, value):
        self.value = value

    def eval(self, ctx, schip):
        return self.value


class _Bin(Ast):
    def __init__(self, op, a, b):
        self.op = op
        self.a = a
        self.b = b

    def eval(self, ctx, schip):
        a = self.a.eval(ctx, schip)
        b = self.b.eval(ctx, schip)
        return getattr(schip, self.op)(ctx, a, b)


def _wrap(o):
    return o if isinstance(o, Ast) else V(o)
