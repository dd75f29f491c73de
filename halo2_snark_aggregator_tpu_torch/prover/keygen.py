# Copy of halo2_snark_aggregator_tpu/prover/keygen.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""Keygen: collect circuit assignments, build permutation sigmas, vk/pk.

halo2 keygen_vk/keygen_pk equivalents (the reference invokes these at
verify_circuit.rs:733-765 / 974-979). Permutation sigma construction follows
halo2's permutation keygen: cycles over equality-constrained cells; sigma
polynomial for column j at row i holds delta^{c} * omega^{r} where (c, r) is
the next cell in the cycle.
"""

from __future__ import annotations

import dataclasses

from ..ff.bn254 import FR_DELTA, R
from ..protocol.plonk import ADVICE, FIXED, INSTANCE, Circuit, Column, ConstraintSystem, VerifyingKey
from .domain import Domain
from .kzg import ParamsKZG


class Assignment:
    """Direct row-addressed witness/fixed assignment + copy constraints."""

    def __init__(self, cs: ConstraintSystem, n: int, usable_rows: int,
                 instances: list[list[int]] | None = None,
                 challenges: dict[int, int] | None = None):
        self.cs = cs
        self.n = n
        self.usable_rows = usable_rows
        self.fixed = [[0] * n for _ in range(cs.num_fixed_columns)]
        self.advice = [[0] * n for _ in range(cs.num_advice_columns)]
        self.instances = instances or [[] for _ in range(cs.num_instance_columns)]
        self.copies: list[tuple[Column, int, Column, int]] = []
        # multi-phase proving: challenges squeezed in earlier phases (halo2's
        # Value::unknown semantics — None until the phase that reveals it)
        self.challenges = challenges if challenges is not None else {}
        # highest row any assignment/copy touched: MockProver uses this to
        # bound (soundly) how far a circuit's used_rows_hint may under-scan
        self.max_row_touched = -1

    def get_challenge(self, index: int) -> int | None:
        return self.challenges.get(index)

    def _check_row(self, row: int):
        if row >= self.usable_rows:
            raise ValueError(
                f"row {row} exceeds usable rows ({self.usable_rows} = "
                f"2^k - (blinding_factors + 1) = {self.n} - "
                f"{self.n - self.usable_rows}); increase k or shrink the "
                f"circuit (halo2 reserves the tail rows for blinding)")
        if row > self.max_row_touched:
            self.max_row_touched = row

    def assign_fixed(self, col: Column, row: int, value: int):
        assert col.kind == FIXED
        self._check_row(row)
        self.fixed[col.index][row] = value % R

    def assign_advice(self, col: Column, row: int, value: int):
        assert col.kind == ADVICE
        self._check_row(row)
        self.advice[col.index][row] = value % R

    def query_instance(self, col: Column, row: int) -> int:
        assert col.kind == INSTANCE
        vals = self.instances[col.index]
        return vals[row] if row < len(vals) else 0

    def copy(self, col_a: Column, row_a: int, col_b: Column, row_b: int):
        self._check_row(row_a)
        self._check_row(row_b)
        self.copies.append((col_a, row_a, col_b, row_b))

    def cell_value(self, col: Column, row: int) -> int:
        if col.kind == ADVICE:
            return self.advice[col.index][row]
        if col.kind == FIXED:
            return self.fixed[col.index][row]
        return self.query_instance(col, row)


@dataclasses.dataclass
class ProvingKey:
    vk: VerifyingKey
    domain: Domain
    fixed_lagrange: list[list[int]]
    fixed_coeff: list[list[int]]
    sigmas_lagrange: list[list[int]]  # one per permutation column
    sigmas_coeff: list[list[int]]
    # permutation structure for the prover's z computation:
    perm_mapping: list[list[tuple[int, int]]]  # [col][row] -> (col', row')


def _build_permutation(cs: ConstraintSystem, assignment: Assignment, n: int):
    """Cycle structure over permutation columns -> mapping [col][row]->(col,row)."""
    cols = cs.permutation_columns
    col_pos = {c: i for i, c in enumerate(cols)}
    # mapping starts as identity; build cycles via the standard aux/next trick
    mapping = [[(ci, r) for r in range(n)] for ci in range(len(cols))]
    aux = [[(ci, r) for r in range(n)] for ci in range(len(cols))]
    sizes = {}

    def find(cell):
        path = []
        while aux[cell[0]][cell[1]] != cell:
            path.append(cell)
            cell = aux[cell[0]][cell[1]]
        for p in path:
            aux[p[0]][p[1]] = cell
        return cell

    for col_a, row_a, col_b, row_b in assignment.copies:
        a = (col_pos[col_a], row_a)
        b = (col_pos[col_b], row_b)
        ra, rb = find(a), find(b)
        if ra == rb:
            continue
        # union: splice the two cycles by swapping mapping successors
        mapping[a[0]][a[1]], mapping[b[0]][b[1]] = (
            mapping[b[0]][b[1]],
            mapping[a[0]][a[1]],
        )
        aux[ra[0]][ra[1]] = rb

    return mapping


def keygen(circuit: Circuit, k: int, params: ParamsKZG,
           instances: list[list[int]] | None = None) -> tuple[VerifyingKey, ProvingKey]:
    """Build vk/pk. `instances` is only consulted by circuits that read
    instance cells during fixed assignment (not typical)."""
    cs = ConstraintSystem()
    config = circuit.configure(cs)
    n = 1 << k
    usable = n - (cs.blinding_factors() + 1)
    assignment = Assignment(cs, n, usable, instances)
    circuit.synthesize(config, assignment)

    domain = Domain(k)
    fixed_lagrange = [list(col) for col in assignment.fixed]
    fixed_coeff = [domain.lagrange_to_coeff(col) for col in fixed_lagrange]

    mapping = _build_permutation(cs, assignment, n)
    # deltaomega[c][r] = delta^c * omega^r
    ncols = len(cs.permutation_columns)
    sigmas_lagrange = []
    omega_pows = []
    w = 1
    for _ in range(n):
        omega_pows.append(w)
        w = w * domain.omega % R
    delta_pow = 1
    deltaomega = []
    for _ in range(ncols):
        deltaomega.append([delta_pow * om % R for om in omega_pows])
        delta_pow = delta_pow * FR_DELTA % R
    for ci in range(ncols):
        sigmas_lagrange.append(
            [deltaomega[mc][mr] for (mc, mr) in mapping[ci]]
        )
    sigmas_coeff = [domain.lagrange_to_coeff(s) for s in sigmas_lagrange]

    fixed_commitments = [params.commit_lagrange(col) for col in fixed_lagrange]
    permutation_commitments = [params.commit_lagrange(s) for s in sigmas_lagrange]

    vk = VerifyingKey(
        k=k,
        cs=cs,
        fixed_commitments=fixed_commitments,
        permutation_commitments=permutation_commitments,
    )
    pk = ProvingKey(
        vk=vk,
        domain=domain,
        fixed_lagrange=fixed_lagrange,
        fixed_coeff=fixed_coeff,
        sigmas_lagrange=sigmas_lagrange,
        sigmas_coeff=sigmas_coeff,
        perm_mapping=mapping,
    )
    return vk, pk
