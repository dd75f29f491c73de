# Copy of halo2_snark_aggregator_tpu/solidity/transcript.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""Codegen transcript (reference D6, transcript/codegen.rs): a host ShaRead
replays the actual proof bytes (sampling concrete values and challenges) while
the codegen context records calldata-word reads, hash absorptions, and
squeezes as IR."""

from __future__ import annotations

from ..ff import bn254 as ff
from ..transcript.host import ShaRead
from .chips import SolPoint, SolValue
from .ir import CodegenContext


class CodegenShaTranscript:
    def __init__(self, proof: bytes, cg: CodegenContext, algo: str = "sha256"):
        self.host = ShaRead(proof, algo)
        self.cg = cg

    def read_point(self, ctx, nchip, schip, pchip) -> SolPoint:
        pt = self.host.read_point()
        x = self.cg.transcript_word()
        y = self.cg.transcript_word()
        self.cg.side_effect("hash_point", (x, y))
        return SolPoint(x, y, pt)

    def read_scalar(self, ctx, nchip, schip) -> SolValue:
        v = self.host.read_scalar()
        w = self.cg.transcript_word()
        self.cg.side_effect("hash_scalar", (w,))
        return SolValue(w, v)

    def squeeze_challenge_scalar(self, ctx, nchip, schip) -> SolValue:
        v = self.host.squeeze_challenge()
        return SolValue(self.cg.squeeze(), v)

    def common_scalar(self, ctx, nchip, schip, s: SolValue):
        self.host.common_scalar(s.v)
        self.cg.side_effect("hash_scalar", (s.expr,))

    def common_point(self, ctx, nchip, schip, pchip, p: SolPoint):
        self.host.common_point(p.v)
        self.cg.side_effect("hash_point", (p.x, p.y))

    def at_end(self) -> bool:
        return self.host.at_end()
