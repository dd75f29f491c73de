# Copy of halo2_snark_aggregator_tpu/protocol/transcript.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""Context-generic Poseidon transcript reader.

Mirrors systems/halo2/transcript.rs: proof bytes are parsed host-side
(compressed points / LE scalars — byte positions are static given the vk, cf.
SURVEY §7 hard part 3), assigned into the context, and absorbed through the
chip-based Poseidon sponge. Point encoding for absorption: (x, y) base coords
cast to the scalar field (mock/transcript_encode.rs:29-56).
"""

from __future__ import annotations

from ..ff import bn254 as ff
from ..hashes.poseidon_chip import PoseidonChipSponge


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


class ShaTranscriptRead:
    """Context-generic SHA-2 transcript reader for the OUTER proof (reference
    ShaRead, transcript/sha.rs:15-97 — uncompressed x||y point absorption with
    0x00/0x01/0x02 domain prefixes, BE reversal, squeeze = digest + reseed).

    The reference only ever reads SHA transcripts with value semantics (the
    native VerifyCheck, verify_circuit.rs:1032-1055, and the EVM codegen which
    has its own reader); likewise this reader hashes the concrete values
    (`to_value`) host-side, so it is intended for the value/TPU contexts."""

    def __init__(self, proof: bytes, ctx, nchip, algo: str = "sha256"):
        from ..transcript.host import ShaRead
        self.inner = ShaRead(proof, algo)

    def at_end(self) -> bool:
        return self.inner.at_end()

    def read_point(self, ctx, nchip, schip, pchip):
        pt = self.inner.read_point()
        return pchip.assign_var(ctx, pt)

    def read_constant_point(self, ctx, nchip, schip, pchip):
        pt = self.inner.read_point()
        return pchip.assign_const(ctx, pt)

    def read_scalar(self, ctx, nchip, schip):
        v = self.inner.read_scalar()
        return schip.assign_var(ctx, v)

    def squeeze_challenge_scalar(self, ctx, nchip, schip):
        return schip.assign_var(ctx, self.inner.squeeze_challenge())

    def common_point(self, ctx, nchip, schip, pchip, p):
        self.inner.common_point(pchip.to_value(p))

    def common_scalar(self, ctx, nchip, schip, s):
        self.inner.common_scalar(nchip.to_value(s))
