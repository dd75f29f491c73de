# Copy of halo2_snark_aggregator_tpu/hashes/poseidon_host.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""Host Poseidon sponge matching the reference PoseidonChip semantics.

Mirrors hash/poseidon.rs:144-231 exactly:
  - `update` buffers absorbed elements
  - `squeeze` consumes the buffer in RATE-sized chunks; each chunk runs one
    permutation with the inputs added into state[1..1+len] and a `1` padding
    marker added at state[1+len] when the chunk is short; a full final chunk
    triggers one extra empty-input permutation (poseidon.rs:176-190)
  - the squeezed value is state[1] (poseidon.rs:190)
"""

from __future__ import annotations

from ..ff.bn254 import R
from .poseidon_spec import RATE, T, permute


class PoseidonSponge:
    def __init__(self):
        self.state = [0] * T
        self.absorbing: list[int] = []

    def update(self, elements: list[int]):
        self.absorbing.extend(e % R for e in elements)

    def _permute_with_inputs(self, inputs: list[int]):
        assert len(inputs) < T
        s = list(self.state)
        for i, v in enumerate(inputs):
            s[1 + i] = (s[1 + i] + v) % R
        if len(inputs) < RATE:
            # padding marker inside the same permutation (absorb_with_pre_constants
            # adds `constant + one` at the first position past the inputs)
            s[1 + len(inputs)] = (s[1 + len(inputs)] + 1) % R
        self.state = permute(s)

    def squeeze(self) -> int:
        inputs = self.absorbing
        self.absorbing = []
        padding_offset = 0
        for start in range(0, len(inputs), RATE):
            chunk = inputs[start : start + RATE]
            padding_offset = RATE - len(chunk)
            self._permute_with_inputs(chunk)
        if padding_offset == 0:
            # covers both "last chunk was full" and "nothing absorbed"
            self._permute_with_inputs([])
        return self.state[1]
