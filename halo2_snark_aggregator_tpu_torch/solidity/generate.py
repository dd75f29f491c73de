# Copy of halo2_snark_aggregator_tpu/solidity/generate.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""Solidity verifier generator driver (reference D7, -solidity/src/lib.rs).

Replays an (SHA-transcript) proof through the codegen chips — the same
verify_single_proof_no_eval engine as every other context — producing the IR
statement list whose evaluation yields (w_x, w_g); then optimizes memory with
linear scan and renders verifier.sol. A host pairing check validates the
sampled values (lib.rs:269-284 debug pairing).
"""

from __future__ import annotations

import dataclasses

from ..ff import bn254 as ff
from ..protocol import verify as pv
from .chips import SolidityEccChip, SolidityFieldChip, SolPoint, SolValue
from .ir import CodegenContext
from .transcript import CodegenShaTranscript


@dataclasses.dataclass
class GeneratedVerifier:
    cg: CodegenContext
    wx: SolPoint
    wg: SolPoint
    instance_words: int
    transcript_words: int
    pairing_ok: bool
    algo: str = "sha256"


def generate(vk, params, proof: bytes, instances: list[list[int]],
             algo: str = "sha256") -> GeneratedVerifier:
    """instances: [column][row] public inputs of the single (outer) proof."""
    cg = CodegenContext()
    pchip = SolidityEccChip(cg)
    schip = nchip = pchip.scalar_chip
    ctx = None

    # instances come from calldata words (reference lib.rs:214-224)
    word = 0
    assigned_instances = []
    for column_values in instances:
        col = []
        for v in column_values:
            col.append(SolValue(cg.instance_word(word), v % ff.R))
            word += 1
        assigned_instances.append(col)

    # instance commitments: MSM over g_lagrange constants (verify.rs:617-646)
    commitments = []
    for col in assigned_instances:
        acc = None
        for i, s in enumerate(col):
            term = pchip.scalar_mul_constant(ctx, s, params.g_lagrange[i])
            acc = term if acc is None else pchip.add(ctx, acc, term)
        commitments.append(acc if acc is not None else pchip.assign_zero(ctx))

    transcript = CodegenShaTranscript(proof, cg, algo)
    proof_ast, _advice = pv.verify_single_proof_no_eval(
        ctx, nchip, schip, pchip, [commitments], vk, params, transcript, "",
    )
    wx, wg, ok = pv.evaluate_multiopen_proof(ctx, schip, pchip, proof_ast, params)
    from .aggregate import optimize as group_optimize
    from .optimize import combine_mul_add

    combine_mul_add(cg)   # peephole (reference D4)
    group_optimize(cg)    # packed loops (reference D5)
    return GeneratedVerifier(
        cg=cg,
        wx=wx,
        wg=wg,
        instance_words=cg.instance_words,
        transcript_words=cg.transcript_words,
        pairing_ok=ok,
        algo=algo,
    )
