"""Recording context and the levelized batched executor (the "tape").

The protocol engine runs once per (vk, batch) through `TapeFieldChip`,
recording every scalar op into a tape of SSA slots. `compile_tape` then
schedules it (sponge chain first, then the scalar ops levelized by
dependency depth with each level's inversions batched) and returns an
executor over a slots buffer (n_slots, batch, 8) of Montgomery words on
the device:

  * the whole sponge chain is one Poseidon-kernel launch over the call
    table: call by call, each lane gathers its state and inputs by row,
    absorbs (modular adds), permutes and scatters;
  * each level is one field-kernel launch per op kind, gathering operands
    and scattering results by row index;
  * each inversion level is one batched pow launch.

`Slot`, `Tape`, `TapeFieldChip`, `_tables_from_level_groups` and
`_reordered_plan` are copies of the reference's pure-Python recording and
scheduling (halo2_snark_aggregator_tpu/arith/tape.py, which imports jax);
tests/test_torch_tape.py holds each copy equal to the original. Only the
reordered schedule is ported: a tape whose sponge chain reads a computed
slot is refused.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..hashes import poseidon_spec as pspec
from ..ops import field as fo
from ..ops import poseidon as po
from .api import FieldChip

FR = fo.FR

OP_MUL, OP_ADD, OP_SUB = 0, 1, 2
_OPS = (OP_MUL, OP_ADD, OP_SUB)
_KERNEL_MODE = {OP_MUL: fo.MUL, OP_ADD: fo.ADD, OP_SUB: fo.SUB}


@dataclasses.dataclass(frozen=True)
class Slot:
    idx: int
    level: int


class Tape:
    def __init__(self):
        self.n_slots = 0
        self.records: list[tuple[int, int, int, int]] = []  # (op, a, b, out)
        self.const_slots: dict[int, int] = {}
        self.consts: list[tuple[int, int]] = []  # (slot, value)
        self.input_slots: list[int] = []
        self.poseidon_calls: list[tuple[tuple[int, ...], tuple[int, ...], tuple[int, ...]]] = []
        self.inv_calls: list[tuple[int, int]] = []
        # segments: list of ("ops", [record indices]) | ("poseidon", call index)
        self._segments: list = [("ops", [])]

    def new_slot(self, level: int) -> Slot:
        s = Slot(self.n_slots, level)
        self.n_slots += 1
        return s

    def record(self, op: int, a: Slot, b: Slot) -> Slot:
        out = self.new_slot(max(a.level, b.level) + 1)
        self.records.append((op, a.idx, b.idx, out.idx))
        self._segments[-1][1].append(len(self.records) - 1)
        return out

    def record_inv(self, a: Slot) -> Slot:
        out = self.new_slot(0)
        self.inv_calls.append((a.idx, out.idx))
        self._segments.append(("inv", len(self.inv_calls) - 1))
        self._segments.append(("ops", []))
        return out

    def record_poseidon(self, state: list[Slot], inputs: list[Slot]) -> list[Slot]:
        out = [self.new_slot(0) for _ in range(pspec.T)]
        self.poseidon_calls.append(
            (tuple(s.idx for s in state), tuple(s.idx for s in inputs),
             tuple(s.idx for s in out))
        )
        self._segments.append(("poseidon", len(self.poseidon_calls) - 1))
        self._segments.append(("ops", []))
        return out

    def segments(self):
        return [s for s in self._segments if s[0] != "ops" or s[1]]


class TapeFieldChip(FieldChip):
    """FieldChip that records into a Tape. AssignedValue = Slot."""

    def __init__(self, tape: Tape):
        self.tape = tape

    def assign_const(self, ctx, v: int) -> Slot:
        v %= FR.modulus
        if v in self.tape.const_slots:
            idx = self.tape.const_slots[v]
            return Slot(idx, 0)
        s = self.tape.new_slot(0)
        self.tape.const_slots[v] = s.idx
        self.tape.consts.append((s.idx, v))
        return s

    def assign_input(self, ctx) -> Slot:
        """Declare a runtime input (proof scalar / instance value)."""
        s = self.tape.new_slot(0)
        self.tape.input_slots.append(s.idx)
        return s

    def assign_var(self, ctx, v) -> Slot:
        if isinstance(v, Slot):
            return v
        return self.assign_const(ctx, v)

    def to_value(self, a: Slot):
        raise TypeError("tape values are symbolic; execute the tape instead")

    def add(self, ctx, a, b):
        return self.tape.record(OP_ADD, a, b)

    def sub(self, ctx, a, b):
        return self.tape.record(OP_SUB, a, b)

    def neg(self, ctx, a):
        return self.sub(ctx, self.assign_const(ctx, 0), a)

    def mul(self, ctx, a, b):
        return self.tape.record(OP_MUL, a, b)

    def div(self, ctx, a, b):
        inv_b = self.tape.record_inv(b)
        return self.tape.record(OP_MUL, a, inv_b)

    def sum_with_coeff_and_constant(self, ctx, pairs, constant):
        acc = self.assign_const(ctx, constant)
        for v, c in pairs:
            if c == 1:
                acc = self.add(ctx, acc, v)
            else:
                acc = self.add(ctx, acc, self.mul(ctx, v, self.assign_const(ctx, c)))
        return acc

    def poseidon_permute(self, ctx, state: list, inputs: list) -> list:
        return self.tape.record_poseidon(state, inputs)


# ---------------------------------------------------------------------------
# Scheduling (copied from the reference)
# ---------------------------------------------------------------------------


def _tables_from_level_groups(levels: list[dict[int, list]]):
    """Per-level {op: [(a, b, out)]} groups -> padded scan tables
    ((tables, valid, n_levels, width), the _levelize contract)."""
    width = max(
        (len(v) for g in levels for v in g.values()), default=1
    )
    # tables: per level, per op kind: (a_idx, b_idx, out_idx, valid) padded
    n_levels = len(levels)
    tables = {
        op: np.zeros((n_levels, width, 3), dtype=np.int32) for op in _OPS
    }
    valid = {op: np.zeros((n_levels, width), dtype=bool) for op in _OPS}
    for li, g in enumerate(levels):
        for op, entries in g.items():
            for k, (a, b, out) in enumerate(entries):
                tables[op][li, k] = (a, b, out)
                valid[op][li, k] = True
    return tables, valid, n_levels, width


def _reordered_plan(tape: Tape):
    """Build the reordered schedule: (poseidon scan arrays, plan) or None
    when the tape's sponge chain reads a computed slot (closure violation —
    legal for an exotic chip user, just not schedulable this way)."""
    ok = set(tape.input_slots) | {s for s, _ in tape.consts}
    for st, inp, out in tape.poseidon_calls:
        if any(s not in ok for s in list(st) + list(inp)):
            return None
        ok |= set(out)

    P = len(tape.poseidon_calls)
    rate, t_width = pspec.RATE, pspec.T
    st_idx = np.zeros((P, t_width), np.int32)
    in_idx = np.zeros((P, rate), np.int32)
    in_mask = np.zeros((P, rate), bool)
    pad_oh = np.zeros((P, t_width), np.int32)
    out_idx = np.zeros((P, t_width), np.int32)
    for j, (st, inp, out) in enumerate(tape.poseidon_calls):
        st_idx[j] = st
        n = len(inp)
        in_idx[j, :n] = inp
        in_mask[j, :n] = True
        if n < rate:
            pad_oh[j, 1 + n] = 1  # sponge pad marker (absorb_chunk)
        out_idx[j] = out
    pose = (st_idx, in_idx, in_mask, pad_oh, out_idx) if P else None

    # Global dependency levelization of scalar ops + inversions.  Record
    # order is a valid topological order (SSA slots), so one forward pass
    # assigns levels; inputs/consts/poseidon outputs sit at level 0.
    level_of: dict[int, int] = {}

    def lv(slot: int) -> int:
        return level_of.get(slot, 0)

    ops_by_level: dict[int, dict[int, list]] = {}
    invs_by_level: dict[int, list] = {}
    for seg in tape.segments():
        if seg[0] == "ops":
            for ri in seg[1]:
                op, a, b, out = tape.records[ri]
                level = max(lv(a), lv(b)) + 1
                level_of[out] = level
                ops_by_level.setdefault(level, {}).setdefault(
                    op, []).append((a, b, out))
        elif seg[0] == "inv":
            a, out = tape.inv_calls[seg[1]]
            level = lv(a) + 1
            level_of[out] = level
            invs_by_level.setdefault(level, []).append((a, out))

    # Emit: runs of inv-free levels fold into one scan; each inv-bearing
    # level batches its inversions into a single stacked fr.inv (one pow
    # scan per GROUP).  Ops at an inv level are independent of that level's
    # inv outputs (same level = same prerequisites), so they join the run
    # flushed just before the inv batch.
    plan: list = []
    run_groups: list = []
    for level in range(1, max([*ops_by_level, *invs_by_level], default=0) + 1):
        if level in ops_by_level:
            run_groups.append(ops_by_level[level])
        if level in invs_by_level:
            if run_groups:
                plan.append(("ops", _tables_from_level_groups(run_groups)))
                run_groups = []
            pairs = invs_by_level[level]
            plan.append(("invb", (
                np.asarray([a for a, _ in pairs], np.int32),
                np.asarray([o for _, o in pairs], np.int32))))
    if run_groups:
        plan.append(("ops", _tables_from_level_groups(run_groups)))
    return pose, plan


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


def _idx(arr, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int32)).to(device)


class TapeExecutor:
    """Runs a compiled tape over a batch of lanes on one device.

    `run(inputs)` takes the standard-form input words (n_inputs, batch, 8),
    in tape input order — any value below 2^256, reduced on the way in —
    and returns the slots buffer (n_slots, batch, 8) of Montgomery words.

    H2T_TAPE_SKIP=poseidon|ops|inv (read at compile time) skips that
    segment kind, so a pair of runs attributes phase A's time between the
    sponge chain and the scalar levels. Results are wrong with it set:
    profiling only.
    """

    def __init__(self, tape: Tape, batch: int, device):
        sched = _reordered_plan(tape)
        if sched is None:
            raise ValueError("tape's sponge chain reads a computed slot; "
                             "only the reordered schedule is supported")
        pose, plan = sched
        self.batch = batch
        self.device = device
        self.n_slots = max(tape.n_slots, 1)
        self.skip = os.environ.get("H2T_TAPE_SKIP", "")
        self.const_idx = _idx([s for s, _ in tape.consts], device)
        self.const_words = fo.mont_words(FR, [v for _, v in tape.consts], device)
        self.input_idx = _idx(tape.input_slots, device)
        self.r2 = fo.const(FR, FR.r2, device, mont=False)
        self.r2_idx = torch.zeros(len(tape.input_slots), dtype=torch.int32,
                                  device=device)

        self.sponge = None
        if pose is not None:
            st_idx, in_idx, in_mask, pad_oh, out_idx = pose
            pad = np.where(pad_oh.any(axis=1), np.argmax(pad_oh, axis=1), -1)
            self.sponge = po.chain_table(st_idx, in_idx, in_mask.sum(axis=1),
                                         pad, out_idx, device)

        self.steps = []  # ("ops", mode, a, b, out) | ("inv", a, out)
        for kind, payload in plan:
            if kind == "invb":
                a_idx, out_idx = payload
                self.steps.append(("inv", _idx(a_idx, device), _idx(out_idx, device)))
                continue
            tables, valid, n_levels, _width = payload
            for li in range(n_levels):
                for op in _OPS:
                    rows = tables[op][li][valid[op][li]]
                    if len(rows):
                        self.steps.append(("ops", _KERNEL_MODE[op],
                                           *(_idx(rows[:, k], device) for k in range(3))))

    def run(self, inputs: torch.Tensor) -> torch.Tensor:
        slots = torch.zeros((self.n_slots, self.batch, fo.WORDS),
                            dtype=torch.int32, device=self.device)
        if len(self.const_idx):
            slots[self.const_idx.long()] = self.const_words.unsqueeze(1)
        if len(self.input_idx):
            fo.field_op(fo.MUL, FR, inputs, self.r2, b_idx=self.r2_idx,
                        b_bcast=True, out=slots, out_idx=self.input_idx)
        if self.sponge is not None and self.skip != "poseidon":
            po.sponge_chain(slots, self.sponge)
        for step in self.steps:
            if step[0] == "ops" and self.skip != "ops":
                _, mode, a, b, out = step
                fo.field_op(mode, FR, slots, slots, a_idx=a, b_idx=b,
                            out=slots, out_idx=out)
            elif step[0] == "inv" and self.skip != "inv":
                _, a, out = step
                fo.field_op(fo.POW, FR, slots, a_idx=a, out=slots,
                            out_idx=out, exponent=FR.modulus - 2)
        return slots


def compile_tape(tape: Tape, batch: int, device) -> TapeExecutor:
    return TapeExecutor(tape, batch, device)
