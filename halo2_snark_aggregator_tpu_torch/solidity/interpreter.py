# Copy of halo2_snark_aggregator_tpu/solidity/interpreter.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""IR interpreter: executes the generated verifier statements exactly as the
EVM contract would (fr arithmetic mod r, EC precompile semantics, the ShaRead
byte protocol for challenges), used to validate codegen end-to-end without a
Solidity toolchain (the reference relies on a waffle/ethers test harness, D9).
"""

from __future__ import annotations

import hashlib

from ..transcript.keccak import new_hash

from ..ff import bn254 as ff
from .ir import CodegenContext, Expr, Statement


class Interpreter:
    def __init__(self, cg: CodegenContext, transcript_words: list[int],
                 instance_words: list[int], algo: str = "sha256"):
        self.cg = cg
        self.transcript = transcript_words
        self.instances = instance_words
        self.env: dict[int, int] = {}
        self.algo = algo
        self.hash_state = new_hash(algo)

    def _val(self, e: Expr) -> int:
        if e.kind == "const":
            return e.value
        if e.kind == "transcript":
            return self.transcript[e.value]
        if e.kind == "instance":
            return self.instances[e.value]
        return self.env[e.value]

    def _point(self, xe: Expr, ye: Expr):
        x, y = self._val(xe), self._val(ye)
        return None if (x == 0 and y == 0) else (x, y)

    def _set_point(self, st: Statement, pt):
        x, y = (0, 0) if pt is None else pt
        self.env[st.dest[0]] = x
        self.env[st.dest[1]] = y

    def run(self):
        R = ff.R
        for st in self.cg.statements:
            op = st.op
            if op == "fr_add":
                self.env[st.dest[0]] = (self._val(st.args[0]) + self._val(st.args[1])) % R
            elif op == "fr_sub":
                self.env[st.dest[0]] = (self._val(st.args[0]) - self._val(st.args[1])) % R
            elif op == "fr_mul":
                self.env[st.dest[0]] = self._val(st.args[0]) * self._val(st.args[1]) % R
            elif op == "fr_mul_add":
                self.env[st.dest[0]] = (
                    self._val(st.args[0]) * self._val(st.args[1]) + self._val(st.args[2])
                ) % R
            elif op == "fr_mul_sub":
                self.env[st.dest[0]] = (
                    self._val(st.args[0]) * self._val(st.args[1]) - self._val(st.args[2])
                ) % R
            elif op == "fr_div":
                self.env[st.dest[0]] = (
                    self._val(st.args[0]) * pow(self._val(st.args[1]), -1, R) % R
                )
            elif op == "ecc_add":
                self._set_point(st, ff.g1_add(
                    self._point(st.args[0], st.args[1]),
                    self._point(st.args[2], st.args[3]),
                ))
            elif op == "ecc_neg":
                self._set_point(st, ff.g1_neg(self._point(st.args[0], st.args[1])))
            elif op == "ecc_mul":
                self._set_point(st, ff.g1_mul(
                    self._point(st.args[0], st.args[1]), self._val(st.args[2])
                ))
            elif op == "fr_sqr_chain":
                acc = self._val(st.args[0])
                for _ in range(st.args[1].value):
                    acc = acc * acc % R
                self.env[st.dest[0]] = acc
            elif op == "fr_horner_pm":
                acc = self._val(st.args[0])
                v = self._val(st.args[1])
                packed, count = st.args[2].value, st.args[3].value
                for i in range(count):
                    t = self.transcript[(packed >> (16 * i)) & 0xFFFF]
                    acc = (acc * v + t) % R
                self.env[st.dest[0]] = acc
            elif op == "fr_dot_mt":
                acc = self._val(st.args[0])
                packed, count = st.args[1].value, st.args[2].value
                for i in range(count):
                    t = self.transcript[(packed >> (16 * i)) & 0xFFFF]
                    acc = (acc + self._val(st.args[3 + i]) * t) % R
                self.env[st.dest[0]] = acc
            elif op == "ecc_dot_pm":
                accp = self._point(st.args[0], st.args[1])
                start, count = st.args[2].value, st.args[3].value
                for i in range(count):
                    x = self.transcript[start + 2 * i]
                    y = self.transcript[start + 2 * i + 1]
                    pt = None if (x, y) == (0, 0) else (x, y)
                    accp = ff.g1_add(
                        accp, ff.g1_mul(pt, self._val(st.args[4 + i])))
                self._set_point(st, accp)
            elif op == "hash_points_run":
                start, count = st.args[0].value, st.args[1].value
                for i in range(count):
                    self.hash_state.update(b"\x00" * 31 + b"\x01")
                    self.hash_state.update(
                        ff.fe_to_bytes(self.transcript[start + 2 * i])[::-1])
                    self.hash_state.update(
                        ff.fe_to_bytes(self.transcript[start + 2 * i + 1])[::-1])
            elif op == "hash_scalars_run":
                start, count = st.args[0].value, st.args[1].value
                for i in range(count):
                    self.hash_state.update(b"\x00" * 31 + b"\x02")
                    self.hash_state.update(
                        ff.fe_to_bytes(self.transcript[start + i])[::-1])
            elif op == "hash_scalar":
                self.hash_state.update(b"\x00" * 31 + b"\x02")
                self.hash_state.update(ff.fe_to_bytes(self._val(st.args[0]))[::-1])
            elif op == "hash_point":
                self.hash_state.update(b"\x00" * 31 + b"\x01")
                self.hash_state.update(ff.fe_to_bytes(self._val(st.args[0]))[::-1])
                self.hash_state.update(ff.fe_to_bytes(self._val(st.args[1]))[::-1])
            elif op == "squeeze":
                self.hash_state.update(b"\x00")
                digest = self.hash_state.digest()
                self.hash_state = new_hash(self.algo)
                self.hash_state.update(digest)
                self.env[st.dest[0]] = ff.fe_from_bytes_wide(digest + b"\x00" * 32, ff.R)
            else:
                raise ValueError(op)

    def point_of(self, p) -> object:
        return self._point(p.x, p.y)


def proof_to_words(proof: bytes) -> list[int]:
    """Calldata words in transcript read order (32-byte LE values)."""
    assert len(proof) % 32 == 0
    return [int.from_bytes(proof[i : i + 32], "little") for i in range(0, len(proof), 32)]
