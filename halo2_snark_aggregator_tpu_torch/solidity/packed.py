# Copy of halo2_snark_aggregator_tpu/solidity/packed.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""Packed-opcode program for the generated verifier (reference D8's
`update()` opcode-stream design, ctx.rs:344-365 / to_short_code:147-166).

The reference compresses `get_wx_wg` by compiling statements into a 32-bit
opcode stream executed by an in-contract interpreter, because a real (k>=22)
outer verifier emits thousands of statements and direct Solidity would blow
the 24,576-byte EVM code-size limit. (In the reference snapshot the scheme
is actually vestigial — `to_mem_code` returns `None` unconditionally, so
every statement falls back to a direct line and no `update()` exists in the
template.) This module implements a WORKING version for our IR:

  * every IR statement (including the group-optimized loop forms) encodes
    into a variable-length byte record: 1 opcode byte, 2-byte destination
    slots, 2-byte operands (2-bit kind: memory / proof calldata / instance
    calldata / constant-pool + 14-bit index), 2-byte immediates;
  * constants dedupe into a 32-byte-word pool blob;
  * the whole program ships as two `bytes constant` blobs — contract size
    grows ~7 bytes per statement instead of ~40-80 bytes of compiled code;
  * the contract's `exec_ops` loop (render.py `render(..., packed=True)`)
    interprets the stream; `run_packed` below is the bit-exact Python
    executor used by the tests to prove the encoding reproduces (w_x, w_g).
"""

from __future__ import annotations

import dataclasses
import hashlib

from ..transcript.keccak import new_hash

from ..ff import bn254 as ff
from .generate import GeneratedVerifier
from .ir import Expr
from .linear_scan import allocate_slots

# operand kinds (2 bits)
K_MEM, K_PROOF, K_INSTANCE, K_CONST = 0, 1, 2, 3

OPS = {
    "fr_add": 1,
    "fr_sub": 2,
    "fr_mul": 3,
    "fr_div": 4,
    "fr_mul_add": 5,
    "fr_mul_sub": 6,
    "ecc_add": 7,
    "ecc_neg": 8,
    "ecc_mul": 9,
    "fr_sqr_chain": 10,
    "fr_horner_pm": 11,
    "fr_dot_mt": 12,
    "hash_points_run": 13,
    "hash_scalars_run": 14,
    "hash_scalar": 15,
    "hash_point": 16,
    "squeeze": 17,
    "ecc_dot_pm": 18,
}


@dataclasses.dataclass
class PackedProgram:
    ops: bytes               # opcode stream
    cpool: list[int]         # 32-byte constant words
    memory_size: int
    out_operands: tuple      # (wx.x, wx.y, wg.x, wg.y) encoded operands
    transcript_words: int
    instance_words: int


class _Encoder:
    def __init__(self, slot_of: dict[int, int]):
        self.slot_of = slot_of
        self.buf = bytearray()
        self.cpool: list[int] = []
        self._cidx: dict[int, int] = {}

    def const_idx(self, v: int) -> int:
        v %= 1 << 256
        idx = self._cidx.get(v)
        if idx is None:
            idx = len(self.cpool)
            self.cpool.append(v)
            self._cidx[v] = idx
        return idx

    def operand(self, e: Expr) -> int:
        if e.kind == "const":
            kind, idx = K_CONST, self.const_idx(e.value)
        elif e.kind == "transcript":
            kind, idx = K_PROOF, e.value
        elif e.kind == "instance":
            kind, idx = K_INSTANCE, e.value
        else:
            kind, idx = K_MEM, self.slot_of[e.value]
        assert idx < (1 << 14), f"operand index overflow: {idx}"
        return (kind << 14) | idx

    def u16(self, v: int):
        assert 0 <= v < (1 << 16)
        self.buf += v.to_bytes(2, "big")

    def op(self, name: str):
        self.buf.append(OPS[name])

    def dest(self, ssa: int):
        self.u16(self.slot_of[ssa])


def encode(gen: GeneratedVerifier) -> PackedProgram:
    outs = [gen.wx.x, gen.wx.y, gen.wg.x, gen.wg.y]
    keep = [e.value for e in outs if e.kind == "var"]
    slot_of, total = allocate_slots(gen.cg, keep_live=keep)
    enc = _Encoder(slot_of)

    for st in gen.cg.statements:
        o = st.op
        enc.op(o)
        if o in ("fr_add", "fr_sub", "fr_mul", "fr_div"):
            enc.dest(st.dest[0])
            enc.u16(enc.operand(st.args[0]))
            enc.u16(enc.operand(st.args[1]))
        elif o in ("fr_mul_add", "fr_mul_sub"):
            enc.dest(st.dest[0])
            for a in st.args[:3]:
                enc.u16(enc.operand(a))
        elif o == "ecc_add":
            enc.dest(st.dest[0])
            enc.dest(st.dest[1])
            for a in st.args[:4]:
                enc.u16(enc.operand(a))
        elif o == "ecc_neg":
            enc.dest(st.dest[0])
            enc.dest(st.dest[1])
            for a in st.args[:2]:
                enc.u16(enc.operand(a))
        elif o == "ecc_mul":
            enc.dest(st.dest[0])
            enc.dest(st.dest[1])
            for a in st.args[:3]:
                enc.u16(enc.operand(a))
        elif o == "fr_sqr_chain":
            enc.dest(st.dest[0])
            enc.u16(enc.operand(st.args[0]))
            enc.u16(st.args[1].value)          # count immediate
        elif o == "fr_horner_pm":
            enc.dest(st.dest[0])
            enc.u16(enc.operand(st.args[0]))   # acc
            enc.u16(enc.operand(st.args[1]))   # v
            enc.u16(enc.const_idx(st.args[2].value))  # packed proof offsets
            enc.u16(st.args[3].value)          # count immediate
        elif o == "fr_dot_mt":
            # pack the memory slots of args[3:] into one constant word
            packed_m = 0
            for i, e in enumerate(st.args[3 + 0:]):
                s = slot_of[e.value]
                assert s < (1 << 16)
                packed_m |= s << (16 * i)
            enc.dest(st.dest[0])
            enc.u16(enc.operand(st.args[0]))   # acc
            enc.u16(enc.const_idx(st.args[1].value))  # packed proof offsets
            enc.u16(enc.const_idx(packed_m))   # packed memory slots
            enc.u16(st.args[2].value)          # count immediate
        elif o == "ecc_dot_pm":
            packed_m = 0
            for i, e in enumerate(st.args[4:]):
                s = slot_of[e.value]
                assert s < (1 << 16)
                packed_m |= s << (16 * i)
            enc.dest(st.dest[0])
            enc.dest(st.dest[1])
            enc.u16(enc.operand(st.args[0]))   # acc x
            enc.u16(enc.operand(st.args[1]))   # acc y
            enc.u16(st.args[2].value)          # proof start immediate
            enc.u16(enc.const_idx(packed_m))   # packed memory slots
            enc.u16(st.args[3].value)          # count immediate
        elif o in ("hash_points_run", "hash_scalars_run"):
            enc.u16(st.args[0].value)          # start immediate
            enc.u16(st.args[1].value)          # count immediate
        elif o == "hash_scalar":
            enc.u16(enc.operand(st.args[0]))
        elif o == "hash_point":
            enc.u16(enc.operand(st.args[0]))
            enc.u16(enc.operand(st.args[1]))
        elif o == "squeeze":
            enc.dest(st.dest[0])
        else:
            raise ValueError(o)

    return PackedProgram(
        ops=bytes(enc.buf),
        cpool=enc.cpool,
        memory_size=max(total, 1),
        out_operands=tuple(enc.operand(e) for e in outs),
        transcript_words=gen.cg.transcript_words,
        instance_words=gen.cg.instance_words,
    )


def run_packed(prog: PackedProgram, proof_words: list[int],
               instance_words: list[int], algo: str = "sha256"):
    """Bit-exact Python executor of the opcode stream (mirrors the Solidity
    exec_ops loop). Returns (wx, wg) affine int points (None = identity)."""
    R = ff.R
    m = [0] * prog.memory_size
    ops = prog.ops
    state = new_hash(algo)

    def ld(o: int) -> int:
        kind, idx = o >> 14, o & 0x3FFF
        if kind == K_MEM:
            return m[idx]
        if kind == K_PROOF:
            return proof_words[idx]
        if kind == K_INSTANCE:
            return instance_words[idx]
        return prog.cpool[idx]

    def pt(x: int, y: int):
        return None if (x == 0 and y == 0) else (x, y)

    def set_pt(dx: int, dy: int, p):
        m[dx], m[dy] = (0, 0) if p is None else p

    def absorb_scalar(v: int):
        state.update(b"\x00" * 31 + b"\x02" + ff.fe_to_bytes(v)[::-1])

    def absorb_point(x: int, y: int):
        state.update(b"\x00" * 31 + b"\x01"
                     + ff.fe_to_bytes(x)[::-1] + ff.fe_to_bytes(y)[::-1])

    pc = 0

    def u8():
        nonlocal pc
        v = ops[pc]
        pc += 1
        return v

    def u16():
        nonlocal pc
        v = int.from_bytes(ops[pc : pc + 2], "big")
        pc += 2
        return v

    while pc < len(ops):
        op = u8()
        if op == OPS["fr_add"]:
            d, a, b = u16(), ld(u16()), ld(u16())
            m[d] = (a + b) % R
        elif op == OPS["fr_sub"]:
            d, a, b = u16(), ld(u16()), ld(u16())
            m[d] = (a - b) % R
        elif op == OPS["fr_mul"]:
            d, a, b = u16(), ld(u16()), ld(u16())
            m[d] = a * b % R
        elif op == OPS["fr_div"]:
            d, a, b = u16(), ld(u16()), ld(u16())
            m[d] = a * pow(b, -1, R) % R
        elif op == OPS["fr_mul_add"]:
            d, a, b, c = u16(), ld(u16()), ld(u16()), ld(u16())
            m[d] = (a * b + c) % R
        elif op == OPS["fr_mul_sub"]:
            d, a, b, c = u16(), ld(u16()), ld(u16()), ld(u16())
            m[d] = (a * b - c) % R
        elif op == OPS["ecc_add"]:
            dx, dy = u16(), u16()
            ax, ay, bx, by = ld(u16()), ld(u16()), ld(u16()), ld(u16())
            set_pt(dx, dy, ff.g1_add(pt(ax, ay), pt(bx, by)))
        elif op == OPS["ecc_neg"]:
            dx, dy = u16(), u16()
            ax, ay = ld(u16()), ld(u16())
            set_pt(dx, dy, ff.g1_neg(pt(ax, ay)))
        elif op == OPS["ecc_mul"]:
            dx, dy = u16(), u16()
            px, py, s = ld(u16()), ld(u16()), ld(u16())
            set_pt(dx, dy, ff.g1_mul(pt(px, py), s))
        elif op == OPS["fr_sqr_chain"]:
            d, acc, count = u16(), ld(u16()), u16()
            for _ in range(count):
                acc = acc * acc % R
            m[d] = acc
        elif op == OPS["fr_horner_pm"]:
            d, acc, v = u16(), ld(u16()), ld(u16())
            packed, count = prog.cpool[u16()], u16()
            for i in range(count):
                acc = (acc * v + proof_words[(packed >> (16 * i)) & 0xFFFF]) % R
            m[d] = acc
        elif op == OPS["fr_dot_mt"]:
            d, acc = u16(), ld(u16())
            packed_t, packed_m, count = prog.cpool[u16()], prog.cpool[u16()], u16()
            for i in range(count):
                t = proof_words[(packed_t >> (16 * i)) & 0xFFFF]
                acc = (acc + m[(packed_m >> (16 * i)) & 0xFFFF] * t) % R
            m[d] = acc
        elif op == OPS["ecc_dot_pm"]:
            dx, dy = u16(), u16()
            accp = pt(ld(u16()), ld(u16()))
            start, packed_m, count = u16(), prog.cpool[u16()], u16()
            for i in range(count):
                p = pt(proof_words[start + 2 * i],
                       proof_words[start + 2 * i + 1])
                accp = ff.g1_add(
                    accp, ff.g1_mul(p, m[(packed_m >> (16 * i)) & 0xFFFF]))
            set_pt(dx, dy, accp)
        elif op == OPS["hash_points_run"]:
            start, count = u16(), u16()
            for i in range(count):
                absorb_point(proof_words[start + 2 * i],
                             proof_words[start + 2 * i + 1])
        elif op == OPS["hash_scalars_run"]:
            start, count = u16(), u16()
            for i in range(count):
                absorb_scalar(proof_words[start + i])
        elif op == OPS["hash_scalar"]:
            absorb_scalar(ld(u16()))
        elif op == OPS["hash_point"]:
            x, y = ld(u16()), ld(u16())
            absorb_point(x, y)
        elif op == OPS["squeeze"]:
            d = u16()
            state.update(b"\x00")
            digest = state.digest()
            state = new_hash(algo)
            state.update(digest)
            m[d] = ff.fe_from_bytes_wide(digest + b"\x00" * 32, R)
        else:
            raise ValueError(f"bad opcode {op} at pc {pc - 1}")

    wxx, wxy, wgx, wgy = (ld(o) for o in prog.out_operands)
    return pt(wxx, wxy), pt(wgx, wgy)
