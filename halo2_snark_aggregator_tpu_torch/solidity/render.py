# Copy of halo2_snark_aggregator_tpu/solidity/render.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""verifier.sol renderer (reference D8, templates/verifier.sol).

Projects the optimized statement list into a self-contained Solidity contract:
fr arithmetic via addmod/mulmod, inversion via the modexp precompile (0x05),
EC ops via precompiles 0x06/0x07, transcript challenges via the sha256
precompile exactly in the ShaRead byte protocol (31 zero bytes + domain
prefix + big-endian words; squeeze reseeds the state with the digest), and
the final check via ecPairing (0x08) against [s]G2 and -G2 baked from params.

Statement compression: the group optimizers (solidity/aggregate.py, reference
D5) collapse absorb runs, Horner folds, dot products and squaring chains into
packed loop statements (16-bit offsets packed into constant words, mirroring
the reference's fr_mul_add_pm/mt opcodes); everything else is emitted as
direct statements after linear-scan slot allocation.
"""

from __future__ import annotations

from ..ff import bn254 as ff
from .generate import GeneratedVerifier
from .ir import Expr
from .linear_scan import allocate_slots
from .packed import OPS as _PACKED_OPS, PackedProgram, encode as _encode_packed


_SOL_HELPERS = """    function digest_to_fr(bytes32 d) internal pure returns (uint256 v) {
        // little-endian interpretation reduced mod r (Rust from_bytes_wide)
        for (uint256 i = 0; i < 32; i++) {
            v = (v << 8) | uint256(uint8(d[31 - i]));
        }
        v = v % R_MOD;
    }

    function fr_invert(uint256 a) internal view returns (uint256 result) {
        bool success;
        assembly {
            let mPtr := mload(0x40)
            mstore(mPtr, 0x20)
            mstore(add(mPtr, 0x20), 0x20)
            mstore(add(mPtr, 0x40), 0x20)
            mstore(add(mPtr, 0x60), a)
            mstore(add(mPtr, 0x80), sub(R_MOD, 2))
            mstore(add(mPtr, 0xa0), R_MOD)
            success := staticcall(gas(), 0x05, mPtr, 0xc0, 0x00, 0x20)
            result := mload(0x00)
        }
        require(success, "modexp failed");
    }

    function ecc_add(uint256 ax, uint256 ay, uint256 bx, uint256 by)
        internal view returns (uint256 cx, uint256 cy)
    {
        bool success;
        assembly {
            let mPtr := mload(0x40)
            mstore(mPtr, ax)
            mstore(add(mPtr, 0x20), ay)
            mstore(add(mPtr, 0x40), bx)
            mstore(add(mPtr, 0x60), by)
            success := staticcall(gas(), 0x06, mPtr, 0x80, 0x00, 0x40)
            cx := mload(0x00)
            cy := mload(0x20)
        }
        require(success, "ec add failed");
    }

    function ecc_mul(uint256 px, uint256 py, uint256 s)
        internal view returns (uint256 cx, uint256 cy)
    {
        bool success;
        assembly {
            let mPtr := mload(0x40)
            mstore(mPtr, px)
            mstore(add(mPtr, 0x20), py)
            mstore(add(mPtr, 0x40), s)
            success := staticcall(gas(), 0x07, mPtr, 0x60, 0x00, 0x40)
            cx := mload(0x00)
            cy := mload(0x20)
        }
        require(success, "ec mul failed");
    }"""


def _sol_pairing(sg2, ng2, name: str = "pairing_check") -> str:
    return f"""    function {name}(uint256 wx_x, uint256 wx_y, uint256 wg_x, uint256 wg_y)
        internal view returns (bool)
    {{
        uint256[12] memory input;
        input[0] = wx_x;
        input[1] = wx_y;
        input[2] = {sg2[0].c1};  // [s]G2 x.c1
        input[3] = {sg2[0].c0};  // [s]G2 x.c0
        input[4] = {sg2[1].c1};  // [s]G2 y.c1
        input[5] = {sg2[1].c0};  // [s]G2 y.c0
        input[6] = wg_x;
        input[7] = wg_y;
        input[8] = {ng2[0].c1};  // -G2 x.c1
        input[9] = {ng2[0].c0};  // -G2 x.c0
        input[10] = {ng2[1].c1}; // -G2 y.c1
        input[11] = {ng2[1].c0}; // -G2 y.c0
        uint256[1] memory out;
        bool success;
        assembly {{
            success := staticcall(gas(), 0x08, input, 0x180, out, 0x20)
        }}
        require(success, "pairing failed");
        return out[0] == 1;
    }}"""


def _verify_entries(nwords: int, iw: int, target_g2=None) -> str:
    """The public entry points, reference-template-shaped: verify() copies
    the dynamic instance calldata into the fixed memory array get_wx_wg
    takes (verifier.sol:340), and — for aggregator-shaped verifiers (>= 4
    instance words, target params supplied) — verify_final_pair() packs the
    TARGET circuits' raw final pair into the leading 136-bit instance words
    on-chain (verifier.sol:356-365) AND pairing-checks that inner pair
    against the target circuits' G2 points (verifier.sol:388-397: the
    aggregation circuit computes but does not pair the inner fold; the
    contract closes it)."""
    iw_decl = max(iw, 1)
    entries = f"""
    function verify(uint256[] calldata proof, uint256[] calldata instances)
        public view returns (bool)
    {{
        require(proof.length == {nwords}, "bad proof length");
        require(instances.length == {iw}, "bad instance length");
        uint256[{iw_decl}] memory inst;
        for (uint256 i = 0; i < {iw}; i++) {{ inst[i] = instances[i]; }}
        (uint256 wx_x, uint256 wx_y, uint256 wg_x, uint256 wg_y) =
            get_wx_wg(proof, inst);
        return pairing_check(wx_x, wx_y, wg_x, wg_y);
    }}
"""
    if iw >= 4 and target_g2 is not None:
        sg2_t, ng2_t = target_g2
        entries += "\n" + _sol_pairing(sg2_t, ng2_t,
                                       name="pairing_check_target") + "\n"
        entries += f"""
    function verify_final_pair(
        uint256[] calldata proof,
        uint256[] calldata target_circuit_final_pair,
        uint256[] calldata rest_instances
    ) public view returns (bool) {{
        require(proof.length == {nwords}, "bad proof length");
        require(target_circuit_final_pair.length == 4, "bad pair length");
        require(rest_instances.length == {iw - 4}, "bad instance length");
        require(pairing_check_target(
            target_circuit_final_pair[0], target_circuit_final_pair[1],
            target_circuit_final_pair[2], target_circuit_final_pair[3]),
            "target pairing failed");
        uint256[{iw_decl}] memory inst;
        inst[0] = target_circuit_final_pair[0] & ((1 << 136) - 1);
        inst[1] = (target_circuit_final_pair[0] >> 136)
            + ((target_circuit_final_pair[1] & 1) << 136);
        inst[2] = target_circuit_final_pair[2] & ((1 << 136) - 1);
        inst[3] = (target_circuit_final_pair[2] >> 136)
            + ((target_circuit_final_pair[3] & 1) << 136);
        for (uint256 i = 4; i < {iw}; i++) {{
            inst[i] = rest_instances[i - 4];
        }}
        (uint256 wx_x, uint256 wx_y, uint256 wg_x, uint256 wg_y) =
            get_wx_wg(proof, inst);
        return pairing_check(wx_x, wx_y, wg_x, wg_y);
    }}
"""
    return entries


def _hash_call(algo: str) -> str:
    """EVM hash for the transcript: sha256 precompile or the native
    keccak256 opcode (the reference codegen transcript's Keccak256 flavor,
    transcript/codegen.rs:19-37 — far cheaper on-chain)."""
    if algo == "sha256":
        return "sha256"
    if algo == "keccak256":
        return "keccak256"
    raise ValueError(f"no EVM hash for transcript algo {algo!r}")


def _fmt(e: Expr, slot_of) -> str:
    if e.kind == "const":
        return hex(e.value)
    if e.kind == "transcript":
        return f"proof[{e.value}]"
    if e.kind == "instance":
        return f"instances[{e.value}]"
    return f"m[{slot_of[e.value]}]"


def render_packed(gen: GeneratedVerifier, params,
                  target_params=None) -> str:
    """Packed-opcode contract (reference D8's update()-interpreter design,
    ctx.rs:344-365): the whole statement list ships as a `bytes constant`
    opcode blob (+ a 32-byte-word constant pool) executed by an in-contract
    interpreter loop, so `get_wx_wg` code size grows ~7 bytes per statement
    instead of ~40-80 bytes of compiled direct code — the difference between
    fitting the 24,576-byte EVM limit or not for a real k>=22 outer
    verifier. Bit-exact against solidity/packed.run_packed (tested)."""
    prog = _encode_packed(gen)
    ops_hex = prog.ops.hex()
    cpool_hex = "".join(v.to_bytes(32, "big").hex() for v in prog.cpool)
    o = prog.out_operands
    sg2 = params.s_g2
    tg2 = (None if target_params is None else
           (target_params.s_g2, ff.g2_neg(target_params.g2)))
    ng2 = ff.g2_neg(params.g2)

    return f"""// SPDX-License-Identifier: MIT
// Auto-generated halo2 aggregation verifier (halo2-snark-aggregator-tpu,
// packed-opcode interpreter backend).
pragma solidity ^0.8.0;

contract Verifier {{
    uint256 constant Q_MOD = {ff.P};
    uint256 constant R_MOD = {ff.R};

    // opcode stream: op(1B) | dest slots(2B each) | operands(2B: 2-bit kind
    // mem/proof/instance/cpool + 14-bit index) | immediates(2B)
    bytes constant OPS = hex"{ops_hex}";
    // constant pool: 32-byte big-endian words
    bytes constant CPOOL = hex"{cpool_hex}";

{_SOL_HELPERS}

    function ru16(bytes memory b, uint256 i) private pure returns (uint256) {{
        return (uint256(uint8(b[i])) << 8) | uint256(uint8(b[i + 1]));
    }}

    function cword(bytes memory cpool, uint256 idx)
        private pure returns (uint256 v)
    {{
        assembly {{ v := mload(add(add(cpool, 32), mul(idx, 32))) }}
    }}

    function ld(
        uint256 o,
        uint256[] calldata proof,
        uint256[{max(prog.instance_words, 1)}] memory instances,
        uint256[{prog.memory_size}] memory m,
        bytes memory cpool
    ) private pure returns (uint256 v) {{
        uint256 kind = o >> 14;
        uint256 idx = o & 0x3fff;
        if (kind == 0) v = m[idx];
        else if (kind == 1) v = proof[idx];
        else if (kind == 2) v = instances[idx];
        else v = cword(cpool, idx);
    }}

    function get_wx_wg(uint256[] calldata proof,
                       uint256[{max(prog.instance_words, 1)}] memory instances)
        internal view returns (uint256, uint256, uint256, uint256)
    {{
        uint256[{prog.memory_size}] memory m;
        bytes memory ops = OPS;
        bytes memory cpool = CPOOL;
        bytes memory buf;
        uint256 pc = 0;
        while (pc < ops.length) {{
            uint256 op = uint8(ops[pc]); pc += 1;
            if (op <= 6) {{
                uint256 d = ru16(ops, pc); pc += 2;
                uint256 a = ld(ru16(ops, pc), proof, instances, m, cpool); pc += 2;
                uint256 b = ld(ru16(ops, pc), proof, instances, m, cpool); pc += 2;
                if (op == 1) m[d] = addmod(a, b, R_MOD);
                else if (op == 2) m[d] = addmod(a, R_MOD - (b % R_MOD), R_MOD);
                else if (op == 3) m[d] = mulmod(a, b, R_MOD);
                else if (op == 4) m[d] = mulmod(a, fr_invert(b), R_MOD);
                else {{
                    uint256 c = ld(ru16(ops, pc), proof, instances, m, cpool); pc += 2;
                    if (op == 5) m[d] = addmod(mulmod(a, b, R_MOD), c, R_MOD);
                    else m[d] = addmod(mulmod(a, b, R_MOD), R_MOD - (c % R_MOD), R_MOD);
                }}
            }} else if (op == 7) {{
                uint256 dx = ru16(ops, pc); pc += 2;
                uint256 dy = ru16(ops, pc); pc += 2;
                uint256 ax = ld(ru16(ops, pc), proof, instances, m, cpool); pc += 2;
                uint256 ay = ld(ru16(ops, pc), proof, instances, m, cpool); pc += 2;
                uint256 bx = ld(ru16(ops, pc), proof, instances, m, cpool); pc += 2;
                uint256 by = ld(ru16(ops, pc), proof, instances, m, cpool); pc += 2;
                (m[dx], m[dy]) = ecc_add(ax, ay, bx, by);
            }} else if (op == 8) {{
                uint256 dx = ru16(ops, pc); pc += 2;
                uint256 dy = ru16(ops, pc); pc += 2;
                uint256 ax = ld(ru16(ops, pc), proof, instances, m, cpool); pc += 2;
                uint256 ay = ld(ru16(ops, pc), proof, instances, m, cpool); pc += 2;
                m[dx] = ax;
                m[dy] = ay == 0 ? 0 : Q_MOD - ay;
            }} else if (op == 9) {{
                uint256 dx = ru16(ops, pc); pc += 2;
                uint256 dy = ru16(ops, pc); pc += 2;
                uint256 px = ld(ru16(ops, pc), proof, instances, m, cpool); pc += 2;
                uint256 py = ld(ru16(ops, pc), proof, instances, m, cpool); pc += 2;
                uint256 s = ld(ru16(ops, pc), proof, instances, m, cpool); pc += 2;
                (m[dx], m[dy]) = ecc_mul(px, py, s);
            }} else if (op == 10) {{
                uint256 d = ru16(ops, pc); pc += 2;
                uint256 acc = ld(ru16(ops, pc), proof, instances, m, cpool); pc += 2;
                uint256 n = ru16(ops, pc); pc += 2;
                for (uint256 i = 0; i < n; i++) {{ acc = mulmod(acc, acc, R_MOD); }}
                m[d] = acc;
            }} else if (op == 11) {{
                uint256 d = ru16(ops, pc); pc += 2;
                uint256 acc = ld(ru16(ops, pc), proof, instances, m, cpool); pc += 2;
                uint256 v = ld(ru16(ops, pc), proof, instances, m, cpool); pc += 2;
                uint256 packed = cword(cpool, ru16(ops, pc)); pc += 2;
                uint256 n = ru16(ops, pc); pc += 2;
                for (uint256 i = 0; i < n; i++) {{
                    acc = addmod(mulmod(acc, v, R_MOD),
                                 proof[(packed >> (16 * i)) & 0xffff], R_MOD);
                }}
                m[d] = acc;
            }} else if (op == 12) {{
                uint256 d = ru16(ops, pc); pc += 2;
                uint256 acc = ld(ru16(ops, pc), proof, instances, m, cpool); pc += 2;
                uint256 pt = cword(cpool, ru16(ops, pc)); pc += 2;
                uint256 pm = cword(cpool, ru16(ops, pc)); pc += 2;
                uint256 n = ru16(ops, pc); pc += 2;
                for (uint256 i = 0; i < n; i++) {{
                    acc = addmod(acc, mulmod(m[(pm >> (16 * i)) & 0xffff],
                                 proof[(pt >> (16 * i)) & 0xffff], R_MOD), R_MOD);
                }}
                m[d] = acc;
            }} else if (op == 13) {{
                uint256 start = ru16(ops, pc); pc += 2;
                uint256 n = ru16(ops, pc); pc += 2;
                for (uint256 i = 0; i < n; i++) {{
                    buf = abi.encodePacked(buf, bytes31(0), uint8(1),
                        proof[start + 2 * i], proof[start + 2 * i + 1]);
                }}
            }} else if (op == 14) {{
                uint256 start = ru16(ops, pc); pc += 2;
                uint256 n = ru16(ops, pc); pc += 2;
                for (uint256 i = 0; i < n; i++) {{
                    buf = abi.encodePacked(buf, bytes31(0), uint8(2),
                        proof[start + i]);
                }}
            }} else if (op == 15) {{
                uint256 a = ld(ru16(ops, pc), proof, instances, m, cpool); pc += 2;
                buf = abi.encodePacked(buf, bytes31(0), uint8(2), a);
            }} else if (op == 16) {{
                uint256 x = ld(ru16(ops, pc), proof, instances, m, cpool); pc += 2;
                uint256 y = ld(ru16(ops, pc), proof, instances, m, cpool); pc += 2;
                buf = abi.encodePacked(buf, bytes31(0), uint8(1), x, y);
            }} else if (op == 17) {{
                uint256 d = ru16(ops, pc); pc += 2;
                buf = abi.encodePacked(buf, uint8(0));
                bytes32 dg = {_hash_call(gen.algo)}(buf);
                buf = abi.encodePacked(dg);
                m[d] = digest_to_fr(dg);
            }} else if (op == 18) {{
                uint256 dx = ru16(ops, pc); pc += 2;
                uint256 dy = ru16(ops, pc); pc += 2;
                uint256 ax = ld(ru16(ops, pc), proof, instances, m, cpool); pc += 2;
                uint256 ay = ld(ru16(ops, pc), proof, instances, m, cpool); pc += 2;
                uint256 start = ru16(ops, pc); pc += 2;
                uint256 pm = cword(cpool, ru16(ops, pc)); pc += 2;
                uint256 n = ru16(ops, pc); pc += 2;
                for (uint256 i = 0; i < n; i++) {{
                    (uint256 tx, uint256 ty) = ecc_mul(proof[start + 2 * i],
                        proof[start + 2 * i + 1], m[(pm >> (16 * i)) & 0xffff]);
                    (ax, ay) = ecc_add(ax, ay, tx, ty);
                }}
                m[dx] = ax;
                m[dy] = ay;
            }} else {{
                revert("bad opcode");
            }}
        }}
        return (
            ld({o[0]}, proof, instances, m, cpool),
            ld({o[1]}, proof, instances, m, cpool),
            ld({o[2]}, proof, instances, m, cpool),
            ld({o[3]}, proof, instances, m, cpool)
        );
    }}

{_sol_pairing(sg2, ng2)}
{_verify_entries(prog.transcript_words, prog.instance_words, tg2)}
}}
"""


def render(gen: GeneratedVerifier, params, target_params=None) -> str:
    cg = gen.cg
    outs = [gen.wx.x, gen.wx.y, gen.wg.x, gen.wg.y]
    keep = [e.value for e in outs if e.kind == "var"]
    slot_of, total = allocate_slots(cg, keep_live=keep)

    lines: list[str] = []
    emit = lines.append
    for st in cg.statements:
        a = [_fmt(x, slot_of) for x in st.args]
        if st.op == "fr_add":
            emit(f"m[{slot_of[st.dest[0]]}] = addmod({a[0]}, {a[1]}, R_MOD);")
        elif st.op == "fr_sub":
            emit(f"m[{slot_of[st.dest[0]]}] = addmod({a[0]}, R_MOD - ({a[1]} % R_MOD), R_MOD);")
        elif st.op == "fr_mul":
            emit(f"m[{slot_of[st.dest[0]]}] = mulmod({a[0]}, {a[1]}, R_MOD);")
        elif st.op == "fr_mul_add":
            emit(f"m[{slot_of[st.dest[0]]}] = addmod(mulmod({a[0]}, {a[1]}, R_MOD), {a[2]}, R_MOD);")
        elif st.op == "fr_mul_sub":
            emit(f"m[{slot_of[st.dest[0]]}] = addmod(mulmod({a[0]}, {a[1]}, R_MOD), R_MOD - ({a[2]} % R_MOD), R_MOD);")
        elif st.op == "fr_div":
            emit(f"m[{slot_of[st.dest[0]]}] = mulmod({a[0]}, fr_invert({a[1]}), R_MOD);")
        elif st.op == "ecc_add":
            emit(
                f"(m[{slot_of[st.dest[0]]}], m[{slot_of[st.dest[1]]}]) = "
                f"ecc_add({a[0]}, {a[1]}, {a[2]}, {a[3]});"
            )
        elif st.op == "ecc_neg":
            emit(f"m[{slot_of[st.dest[0]]}] = {a[0]};")
            emit(f"m[{slot_of[st.dest[1]]}] = {a[1]} == 0 ? 0 : Q_MOD - {a[1]};")
        elif st.op == "ecc_mul":
            emit(
                f"(m[{slot_of[st.dest[0]]}], m[{slot_of[st.dest[1]]}]) = "
                f"ecc_mul({a[0]}, {a[1]}, {a[2]});"
            )
        elif st.op == "fr_sqr_chain":
            emit("{")
            emit(f"    uint256 acc = {a[0]};")
            emit(f"    for (uint256 i = 0; i < {st.args[1].value}; i++) "
                 "{ acc = mulmod(acc, acc, R_MOD); }")
            emit(f"    m[{slot_of[st.dest[0]]}] = acc;")
            emit("}")
        elif st.op == "fr_horner_pm":
            packed, count = st.args[2].value, st.args[3].value
            emit("{")
            emit(f"    uint256 acc = {a[0]};")
            emit(f"    uint256 offs = {hex(packed)};")
            emit(f"    for (uint256 i = 0; i < {count}; i++) {{")
            emit(f"        acc = addmod(mulmod(acc, {a[1]}, R_MOD), "
                 "proof[(offs >> (16 * i)) & 0xffff], R_MOD);")
            emit("    }")
            emit(f"    m[{slot_of[st.dest[0]]}] = acc;")
            emit("}")
        elif st.op == "fr_dot_mt":
            packed_t, count = st.args[1].value, st.args[2].value
            m_slots = [slot_of[e.value] for e in st.args[3:]]
            packed_m = 0
            for i, s in enumerate(m_slots):
                assert s < (1 << 16)
                packed_m |= s << (16 * i)
            emit("{")
            emit(f"    uint256 acc = {a[0]};")
            emit(f"    uint256 toffs = {hex(packed_t)};")
            emit(f"    uint256 moffs = {hex(packed_m)};")
            emit(f"    for (uint256 i = 0; i < {count}; i++) {{")
            emit("        acc = addmod(acc, mulmod(m[(moffs >> (16 * i)) & 0xffff], "
                 "proof[(toffs >> (16 * i)) & 0xffff], R_MOD), R_MOD);")
            emit("    }")
            emit(f"    m[{slot_of[st.dest[0]]}] = acc;")
            emit("}")
        elif st.op == "ecc_dot_pm":
            start, count = st.args[2].value, st.args[3].value
            m_slots = [slot_of[e.value] for e in st.args[4:]]
            packed_m = 0
            for i, s in enumerate(m_slots):
                assert s < (1 << 16)
                packed_m |= s << (16 * i)
            emit("{")
            emit(f"    uint256 accx = {a[0]};")
            emit(f"    uint256 accy = {a[1]};")
            emit(f"    uint256 moffs = {hex(packed_m)};")
            emit(f"    for (uint256 i = 0; i < {count}; i++) {{")
            emit(f"        (uint256 tx, uint256 ty) = ecc_mul("
                 f"proof[{start} + 2 * i], proof[{start} + 2 * i + 1], "
                 "m[(moffs >> (16 * i)) & 0xffff]);")
            emit("        (accx, accy) = ecc_add(accx, accy, tx, ty);")
            emit("    }")
            emit(f"    m[{slot_of[st.dest[0]]}] = accx;")
            emit(f"    m[{slot_of[st.dest[1]]}] = accy;")
            emit("}")
        elif st.op == "hash_points_run":
            start, count = st.args[0].value, st.args[1].value
            emit(f"for (uint256 i = 0; i < {count}; i++) {{ "
                 f"buf = abi.encodePacked(buf, bytes31(0), uint8(1), "
                 f"proof[{start} + 2 * i], proof[{start} + 2 * i + 1]); }}")
        elif st.op == "hash_scalars_run":
            start, count = st.args[0].value, st.args[1].value
            emit(f"for (uint256 i = 0; i < {count}; i++) {{ "
                 f"buf = abi.encodePacked(buf, bytes31(0), uint8(2), "
                 f"proof[{start} + i]); }}")
        elif st.op == "hash_scalar":
            emit(f"buf = abi.encodePacked(buf, bytes31(0), uint8(2), {a[0]});")
        elif st.op == "hash_point":
            emit(f"buf = abi.encodePacked(buf, bytes31(0), uint8(1), {a[0]}, {a[1]});")
        elif st.op == "squeeze":
            emit("buf = abi.encodePacked(buf, uint8(0));")
            emit(f"digest = {_hash_call(gen.algo)}(buf);")
            emit("buf = abi.encodePacked(digest);")
            # challenge = from_bytes_wide(digest as LE) like the Rust side
            emit(f"m[{slot_of[st.dest[0]]}] = digest_to_fr(digest);")
        else:
            raise ValueError(st.op)

    body = "\n        ".join(lines)
    sg2 = params.s_g2
    tg2 = (None if target_params is None else
           (target_params.s_g2, ff.g2_neg(target_params.g2)))
    ng2 = ff.g2_neg(params.g2)

    return f"""// SPDX-License-Identifier: MIT
// Auto-generated halo2 aggregation verifier (halo2-snark-aggregator-tpu).
pragma solidity ^0.8.0;

contract Verifier {{
    uint256 constant Q_MOD = {ff.P};
    uint256 constant R_MOD = {ff.R};

{_SOL_HELPERS}

{_sol_pairing(sg2, ng2)}

    function get_wx_wg(uint256[] calldata proof,
                       uint256[{max(gen.instance_words, 1)}] memory instances)
        internal view returns (uint256, uint256, uint256, uint256)
    {{
        uint256[{max(total, 1)}] memory m;
        bytes memory buf;
        bytes32 digest;
        {body}
        return (
            {_fmt(gen.wx.x, slot_of)}, {_fmt(gen.wx.y, slot_of)},
            {_fmt(gen.wg.x, slot_of)}, {_fmt(gen.wg.y, slot_of)}
        );
    }}
{_verify_entries(gen.transcript_words, gen.instance_words, tg2)}
}}
"""
