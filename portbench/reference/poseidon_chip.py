# Frozen copy of halo2_snark_aggregator_tpu_torch/hashes/poseidon_chip.py for the benchmark's
# plain reference: imports rewritten to this folder, the native (C++)
# fast paths removed. It imports nothing of the program under test.
"""Context-generic Poseidon sponge over a FieldChip (reference hash/poseidon.rs).

Runs in every arithmetic context: exact ints in the value context, traced
arrays in the jnp context, constraints in the future circuit context. A chip
may expose `poseidon_permute(ctx, state, inputs, pad)` to fuse the whole
permutation into one kernel (the batched TPU path in ops/poseidon.py);
otherwise the generic per-op schedule below is used, which matches
hash/poseidon.rs:193-230 (absorb folded into the first round constants,
squeeze returns state[1]).
"""

from __future__ import annotations

from .poseidon_spec import RATE, T, generate_constants


class PoseidonChipSponge:
    def __init__(self, chip, ctx):
        self.chip = chip
        self.state = [chip.assign_const(ctx, 0) for _ in range(T)]
        self.absorbing: list = []
        self.rc, self.mds = generate_constants()

    def update(self, elements: list):
        self.absorbing.extend(elements)

    def squeeze(self, ctx):
        inputs = self.absorbing
        self.absorbing = []
        padding_offset = 0
        for start in range(0, len(inputs), RATE):
            chunk = inputs[start : start + RATE]
            padding_offset = RATE - len(chunk)
            self._permute(ctx, chunk)
        if padding_offset == 0:
            self._permute(ctx, [])
        return self.state[1]

    # -- permutation -------------------------------------------------------
    def _permute(self, ctx, inputs: list):
        chip = self.chip
        fused = getattr(chip, "poseidon_permute", None)
        if fused is not None:
            self.state = fused(ctx, self.state, inputs)
            return

        s = list(self.state)
        # absorb: inputs into s[1..], padding marker after them
        for i, v in enumerate(inputs):
            s[1 + i] = chip.add(ctx, s[1 + i], v)
        if len(inputs) < RATE:
            s[1 + len(inputs)] = chip.sum_with_constant(ctx, [s[1 + len(inputs)]], 1)

        half_f = len(self.rc) - 63  # r_f rows split around the partial rows
        r_f = 8
        r_p = len(self.rc) - r_f
        idx = 0
        for _ in range(r_f // 2):
            s = self._full_round(ctx, s, self.rc[idx])
            idx += 1
        for _ in range(r_p):
            s = self._partial_round(ctx, s, self.rc[idx])
            idx += 1
        for _ in range(r_f // 2):
            s = self._full_round(ctx, s, self.rc[idx])
            idx += 1
        self.state = s

    def _sbox(self, ctx, x):
        chip = self.chip
        x2 = chip.mul(ctx, x, x)
        x4 = chip.mul(ctx, x2, x2)
        return chip.mul(ctx, x4, x)

    def _full_round(self, ctx, s, constants):
        chip = self.chip
        s = [chip.sum_with_constant(ctx, [x], c) for x, c in zip(s, constants)]
        s = [self._sbox(ctx, x) for x in s]
        return self._apply_mds(ctx, s)

    def _partial_round(self, ctx, s, constants):
        chip = self.chip
        s = [chip.sum_with_constant(ctx, [x], c) for x, c in zip(s, constants)]
        s[0] = self._sbox(ctx, s[0])
        return self._apply_mds(ctx, s)

    def _apply_mds(self, ctx, s):
        chip = self.chip
        return [
            chip.sum_with_coeff_and_constant(ctx, list(zip(s, row)), 0)
            for row in self.mds
        ]
