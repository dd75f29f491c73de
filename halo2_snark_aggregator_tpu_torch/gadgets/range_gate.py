# Copy of halo2_snark_aggregator_tpu/gadgets/range_gate.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""Range gate: lookup-table range checks (reference B3, gates/range_gate.rs).

A fixed table column holds [0, 2^range_bits); advice cells are constrained
into ranges by lookup. Layout follows the reference's five-column design
(five/range_gate.rs:38-97): the lookups apply DIRECTLY to the base gate's
first four advice columns, each gated by its own fixed selector column, so
one base-gate row range-checks up to four chunks AND recombines them into a
value cell (fifth column) via the row relation — one row per 4 chunks instead
of one row per chunk. Leading chunks narrower than the table width are
tightened with the shift trick (chunk < 2^w iff chunk and chunk<<(bits-w) are
both in the table), the parametric analog of the reference's dedicated
leading-limb lookup families.

range_bits is configurable so gadget tests run at small k (the reference's
2^17-row tables force k>=18, impractical for the host MockProver); production
configs use 17 bits for BN254 Fq limbs (68 = 4 x 17).
"""

from __future__ import annotations

import dataclasses

from ..ff.bn254 import R
from ..protocol.plonk import Column, ConstraintSystem
from .base_gate import AssignedCell, BaseGateConfig, Context, pair

N_LOOKUP_COLS = 4  # base advice columns 0..3 carry the lookups


@dataclasses.dataclass
class RangeGateConfig:
    bits: int
    table: Column            # fixed lookup table [0, 2^bits)
    selectors: list[Column]  # fixed 0/1 gating per looked-up advice column


class RangeGate:
    """One lookup family over the base gate's advice columns."""

    def __init__(self, config: RangeGateConfig, base_gate):
        self.config = config
        self.base_gate = base_gate
        self._sel_idx = [c.index for c in config.selectors]

    @staticmethod
    def configure(cs: ConstraintSystem, bits: int,
                  base_cfg: BaseGateConfig) -> RangeGateConfig:
        table = cs.fixed_column()
        selectors = [cs.fixed_column() for _ in range(N_LOOKUP_COLS)]
        for adv, sel in zip(base_cfg.advice[:N_LOOKUP_COLS], selectors):
            # gated lookup: sel * value must be in table (0 is in the table,
            # so ungated rows pass with sel = 0)
            cs.lookup(
                f"range{bits}",
                [(cs.query_fixed(sel, 0) * cs.query_advice(adv, 0),
                  cs.query_fixed(table, 0))],
            )
        return RangeGateConfig(bits, table, selectors)

    def init_table(self, assigner):
        """Fill the fixed table (range_gate.rs init_table)."""
        for i in range(1 << self.config.bits):
            assigner.assign_fixed(self.config.table, i, i)

    def _enable(self, ctx: Context, row: int, n: int):
        fixed = ctx.assignment.fixed
        for i in range(n):
            fixed[self._sel_idx[i]][row] = 1

    def assign_ranged(self, ctx: Context, value: int, bits_total: int) -> AssignedCell:
        """Witness `value` < 2^bits_total: decompose into table-width chunks
        placed up-to-4-per-row in the looked-up advice columns, recombined by
        the same rows' gate relation (partial sums chained via next_coeff).
        The leading chunk, when narrower than the table width, costs one
        extra tighten row (shift trick, bound to the original chunk cell via
        an equality copy). Returns the recombined value cell."""
        bits = self.config.bits
        gate = self.base_gate
        assert bits_total >= 1
        m = max(1, -(-bits_total // bits))
        assert 0 <= value < (1 << bits_total), "witness exceeds range"
        mask = (1 << bits) - 1
        chunks = [(value >> (bits * i)) & mask for i in range(m)]
        lead_bits = bits_total - bits * (m - 1)

        chunk_cells: list[AssignedCell] = []
        out_cell = None
        idx = 0
        acc_cell = None
        acc_val = 0
        while idx < m:
            row = ctx.offset
            if acc_cell is None:
                cap = N_LOOKUP_COLS
                pairs = []
                lead = 0
            else:
                cap = N_LOOKUP_COLS - 1
                pairs = [(acc_cell, 1)]
                lead = 1
            take = min(cap, m - idx)
            pairs += [pair(chunks[idx + j], pow(2, bits * (idx + j), R))
                      for j in range(take)]
            new_acc = (acc_val + sum(
                chunks[idx + j] * pow(2, bits * (idx + j), R)
                for j in range(take))) % R
            last = idx + take >= m
            if last:
                # the value cell lands in the final (never looked-up) column
                pairs += [pair(0, 0)] * (1 + N_LOOKUP_COLS - lead - take)
                pairs[-1] = pair(value % R, R - 1)
                cells = gate.one_line(ctx, pairs)
                out_cell = cells[-1]
            else:
                cells = gate.one_line(ctx, pairs, mul_next=(0, 0, R - 1))
            fixed = ctx.assignment.fixed
            for j in range(lead, lead + take):
                fixed[self._sel_idx[j]][row] = 1
            chunk_cells += cells[lead:lead + take]
            if not last:
                acc_cell = AssignedCell(0, ctx.offset, new_acc)
                acc_val = new_acc
            idx += take

        if lead_bits < bits:
            # tighten: lead chunk < 2^lead_bits via looking up the shifted
            # value; the chunk cell is equality-copied into the tighten row,
            # so the bound applies to the recombined witness
            shift = bits - lead_bits
            lead_cell = chunk_cells[-1]
            row = ctx.offset
            gate.one_line(
                ctx,
                [(lead_cell, pow(2, shift, R)),
                 pair(int(lead_cell) << shift, R - 1)],
            )
            self._enable(ctx, row, 2)
        return out_cell

    def check_range(self, ctx: Context, cell, bits_total: int):
        """Constrain an existing base-gate cell to [0, 2^bits_total)."""
        recombined = self.assign_ranged(ctx, int(cell), bits_total)
        self.base_gate.assert_equal(ctx, cell, recombined)
        return recombined
