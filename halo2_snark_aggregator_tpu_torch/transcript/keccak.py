# Copy of halo2_snark_aggregator_tpu/transcript/keccak.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""Keccak-256 (the pre-NIST Ethereum variant: 0x01 domain padding, NOT
sha3-256's 0x06) with a hashlib-like interface.

The reference's Solidity codegen transcript hashes with Keccak256
(halo2-snark-aggregator-solidity/src/transcript/codegen.rs:19-37,
ShaRead<_, _, Keccak256, ...>) because keccak256 is a native EVM opcode —
far cheaper on-chain than the sha256 precompile. hashlib only ships
sha3-256, whose padding differs, so the permutation is implemented here;
tests pin the function against the well-known empty-string and "abc"
digests (external KATs).
"""

from __future__ import annotations

_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_MASK = (1 << 64) - 1


def _rotl(v: int, n: int) -> int:
    return ((v << n) | (v >> (64 - n))) & _MASK


def _keccak_f(a: list) -> None:
    """In-place keccak-f[1600] on a 5x5 lane matrix a[x][y]."""
    for rc in _RC:
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(a[x][y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y])
        # iota
        a[0][0] ^= rc


class Keccak256:
    """hashlib-style: update()/digest()/copy(). Rate 136 bytes, 0x01 pad."""

    digest_size = 32
    rate = 136

    def __init__(self, data: bytes = b""):
        self._buf = bytearray()
        self._state = [[0] * 5 for _ in range(5)]
        if data:
            self.update(data)

    def update(self, data: bytes) -> "Keccak256":
        self._buf += data
        while len(self._buf) >= self.rate:
            self._absorb(bytes(self._buf[: self.rate]))
            del self._buf[: self.rate]
        return self

    def _absorb(self, block: bytes) -> None:
        for i in range(self.rate // 8):
            lane = int.from_bytes(block[8 * i : 8 * i + 8], "little")
            x, y = i % 5, i // 5
            self._state[x][y] ^= lane
        _keccak_f(self._state)

    def digest(self) -> bytes:
        pad_len = self.rate - len(self._buf)
        if pad_len == 1:
            pad = b"\x81"
        else:
            pad = b"\x01" + b"\x00" * (pad_len - 2) + b"\x80"
        st = [row[:] for row in self._state]
        block = bytes(self._buf) + pad
        for i in range(self.rate // 8):
            lane = int.from_bytes(block[8 * i : 8 * i + 8], "little")
            x, y = i % 5, i // 5
            st[x][y] ^= lane
        _keccak_f(st)
        out = b""
        for i in range(4):  # 32 bytes = 4 lanes
            x, y = i % 5, i // 5
            out += st[x][y].to_bytes(8, "little")
        return out

    def hexdigest(self) -> str:
        return self.digest().hex()

    def copy(self) -> "Keccak256":
        k = Keccak256()
        k._buf = bytearray(self._buf)
        k._state = [row[:] for row in self._state]
        return k


def keccak256(data: bytes = b"") -> Keccak256:
    return Keccak256(data)


def new_hash(algo: str):
    """hashlib.new plus the keccak256 extension used by the transcripts."""
    if algo == "keccak256":
        return Keccak256()
    import hashlib

    return hashlib.new(algo)
