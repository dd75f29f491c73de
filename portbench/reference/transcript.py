# Frozen copy of halo2_snark_aggregator_tpu_torch/protocol/transcript.py for the benchmark's
# plain reference: imports rewritten to this folder, the native (C++)
# fast paths removed. It imports nothing of the program under test.
"""Context-generic Poseidon transcript reader.

Mirrors systems/halo2/transcript.rs: proof bytes are parsed host-side
(compressed points / LE scalars — byte positions are static given the vk, cf.
SURVEY §7 hard part 3), assigned into the context, and absorbed through the
chip-based Poseidon sponge. Point encoding for absorption: (x, y) base coords
cast to the scalar field (mock/transcript_encode.rs:29-56).
"""

from __future__ import annotations

from . import bn254 as ff
from .poseidon_chip import PoseidonChipSponge


class PoseidonTranscriptRead:
    def __init__(self, proof: bytes, ctx, nchip):
        self.proof = proof
        self.offset = 0
        self.hash = PoseidonChipSponge(nchip, ctx)

    def _take(self, n: int) -> bytes:
        if self.offset + n > len(self.proof):
            raise EOFError
        b = self.proof[self.offset : self.offset + n]
        self.offset += n
        return b

    def at_end(self) -> bool:
        return self.offset == len(self.proof)

    def read_point(self, ctx, nchip, schip, pchip):
        pt = ff.g1_from_compressed(self._take(32))
        assigned = pchip.assign_var(ctx, pt)
        self.common_point(ctx, nchip, schip, pchip, assigned)
        return assigned

    def read_constant_point(self, ctx, nchip, schip, pchip):
        pt = ff.g1_from_compressed(self._take(32))
        assigned = pchip.assign_const(ctx, pt)
        self.common_point(ctx, nchip, schip, pchip, assigned)
        return assigned

    def read_scalar(self, ctx, nchip, schip):
        v = ff.fe_from_bytes(self._take(32), ff.R)
        if v is None:
            raise ValueError("non-canonical scalar in proof")
        assigned = schip.assign_var(ctx, v)
        self.common_scalar(ctx, nchip, schip, assigned)
        return assigned

    def squeeze_challenge_scalar(self, ctx, nchip, schip):
        v = self.hash.squeeze(ctx)
        # decode_scalar is the identity cast in the native=scalar setting
        return v

    def common_point(self, ctx, nchip, schip, pchip, p):
        # encode_point: base coords cast into the native field
        x, y = pchip.coords_in_native(ctx, nchip, p)
        self.hash.update([x, y])

    def common_scalar(self, ctx, nchip, schip, s):
        self.hash.update([s])

