# Copy of halo2_snark_aggregator_tpu/transcript/host.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""Host transcript readers/writers (Poseidon and SHA flavors).

Byte formats match the reference exactly:
  - Poseidon transcript (systems/halo2/transcript.rs): points travel as
    32-byte *compressed* G1 (halo2curves layout), scalars as 32-byte LE;
    absorption encodes a point as its two base-field coordinates cast into Fr
    (mock/transcript_encode.rs:29-56), a scalar as itself; challenges are the
    sponge squeeze (state[1]).
  - SHA transcript (transcript/sha.rs): points travel as x||y *uncompressed*
    (32-byte LE each); absorption pads with 31 zero bytes + a 1-byte domain
    prefix (0=challenge, 1=point, 2=scalar) and feeds big-endian coordinate
    bytes; squeeze finalizes the digest, reseeds the state with the result,
    and maps the 32 bytes (zero-extended to 64) into Fr.
"""

from __future__ import annotations

import hashlib

from .keccak import new_hash

from ..ff import bn254 as ff
from ..hashes.poseidon_host import PoseidonSponge

SHA_PREFIX_CHALLENGE = 0
SHA_PREFIX_POINT = 1
SHA_PREFIX_SCALAR = 2


def base_to_scalar(x: int) -> int:
    """Fq value reinterpreted in Fr (field_to_bn -> bn_to_field wide reduce)."""
    return x % ff.R


def encode_point_coords(pt) -> tuple[int, int]:
    if pt is None:
        return (0, 0)
    return pt


# ---------------------------------------------------------------------------
# Poseidon flavor
# ---------------------------------------------------------------------------


class PoseidonWrite:
    """Prover-side transcript (halo2 PoseidonWrite analog)."""

    def __init__(self):
        self.sponge = PoseidonSponge()
        self.buf = bytearray()

    def common_scalar(self, s: int):
        self.sponge.update([s % ff.R])

    def common_point(self, pt):
        x, y = encode_point_coords(pt)
        self.sponge.update([base_to_scalar(x), base_to_scalar(y)])

    def write_scalar(self, s: int):
        self.common_scalar(s)
        self.buf += ff.fe_to_bytes(s % ff.R)

    def write_point(self, pt):
        self.common_point(pt)
        self.buf += ff.g1_to_compressed(pt)

    def squeeze_challenge(self) -> int:
        return self.sponge.squeeze()

    def finalize(self) -> bytes:
        return bytes(self.buf)


class PoseidonRead:
    """Verifier-side transcript over proof bytes (transcript.rs PoseidonTranscriptRead)."""

    def __init__(self, proof: bytes):
        self.sponge = PoseidonSponge()
        self.proof = proof
        self.offset = 0

    def _take(self, n: int) -> bytes:
        if self.offset + n > len(self.proof):
            raise EOFError("transcript exhausted")
        b = self.proof[self.offset : self.offset + n]
        self.offset += n
        return b

    def at_end(self) -> bool:
        return self.offset == len(self.proof)

    def read_point(self):
        pt = ff.g1_from_compressed(self._take(32))
        self.common_point(pt)
        return pt

    def read_scalar(self) -> int:
        v = ff.fe_from_bytes(self._take(32), ff.R)
        if v is None:
            raise ValueError("non-canonical scalar in proof")
        self.common_scalar(v)
        return v

    def common_scalar(self, s: int):
        self.sponge.update([s % ff.R])

    def common_point(self, pt):
        x, y = encode_point_coords(pt)
        self.sponge.update([base_to_scalar(x), base_to_scalar(y)])

    def squeeze_challenge(self) -> int:
        return self.sponge.squeeze()


# ---------------------------------------------------------------------------
# SHA flavor (outer proof; EVM-friendly — sha.rs)
# ---------------------------------------------------------------------------


class _ShaState:
    def __init__(self, algo: str):
        self.algo = algo
        self.state = new_hash(algo)

    def _absorb_fe_be(self, v: int):
        self.state.update(ff.fe_to_bytes(v)[::-1])  # 32 bytes, reversed to BE

    def common_scalar(self, s: int):
        self.state.update(b"\x00" * 31)
        self.state.update(bytes([SHA_PREFIX_SCALAR]))
        self._absorb_fe_be(s % ff.R)

    def common_point(self, pt):
        if pt is None:
            raise ValueError("cannot write points at infinity to the transcript")
        self.state.update(b"\x00" * 31)
        self.state.update(bytes([SHA_PREFIX_POINT]))
        self._absorb_fe_be(pt[0])
        self._absorb_fe_be(pt[1])

    def squeeze_challenge(self) -> int:
        self.state.update(bytes([SHA_PREFIX_CHALLENGE]))
        result = self.state.digest()
        self.state = new_hash(self.algo)
        self.state.update(result)
        return ff.fe_from_bytes_wide(result + b"\x00" * 32, ff.R)


class ShaWrite(_ShaState):
    def __init__(self, algo: str = "sha256"):
        super().__init__(algo)
        self.buf = bytearray()

    def write_scalar(self, s: int):
        self.common_scalar(s)
        self.buf += ff.fe_to_bytes(s % ff.R)

    def write_point(self, pt):
        self.common_point(pt)
        x, y = encode_point_coords(pt)
        self.buf += ff.fe_to_bytes(x)
        self.buf += ff.fe_to_bytes(y)

    def finalize(self) -> bytes:
        return bytes(self.buf)


class ShaRead(_ShaState):
    def __init__(self, proof: bytes, algo: str = "sha256"):
        super().__init__(algo)
        self.proof = proof
        self.offset = 0

    def _take(self, n: int) -> bytes:
        if self.offset + n > len(self.proof):
            raise EOFError("transcript exhausted")
        b = self.proof[self.offset : self.offset + n]
        self.offset += n
        return b

    def at_end(self) -> bool:
        return self.offset == len(self.proof)

    def read_scalar(self) -> int:
        v = ff.fe_from_bytes(self._take(32), ff.R)
        if v is None:
            raise ValueError("non-canonical scalar")
        self.common_scalar(v)
        return v

    def read_point(self):
        x = ff.fe_from_bytes(self._take(32), ff.P)
        y = ff.fe_from_bytes(self._take(32), ff.P)
        if x is None or y is None:
            raise ValueError("non-canonical base field element")
        pt = (x, y)
        if not ff.g1_is_on_curve(pt):
            raise ValueError("point not on curve")
        self.common_point(pt)
        return pt
