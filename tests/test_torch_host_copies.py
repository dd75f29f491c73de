"""The port's copies of the JAX package's host layer stay the reference's
code: each copy's source equals the reference's once the edits declared
at its top are applied to the reference. A copy opens with a comment
block; its `# edit- <line>` / `# edit+ <line>` pairs replace one line of
the reference each. The native C++ source is copied byte for byte."""

from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
REF = REPO / "halo2_snark_aggregator_tpu"
PORT = REPO / "halo2_snark_aggregator_tpu_torch"

COPIES = [
    "ff/bn254.py",
    "hashes/poseidon_spec.py", "hashes/poseidon_host.py",
    "hashes/poseidon_chip.py",
    "transcript/host.py", "transcript/keccak.py",
    "arith/api.py", "arith/value.py",
    "protocol/plonk.py", "protocol/evaluation.py", "protocol/verify.py",
    "protocol/transcript.py", "protocol/queryplan.py",
    "protocol/pinned_compat.py",
    "prover/domain.py", "prover/kzg.py", "prover/keygen.py", "prover/prove.py",
    "circuits/zkevm.py", "circuits/simple.py", "circuits/lookup.py",
    "native/__init__.py",
    "utils/store.py", "protocol/instances.py",
    "gadgets/base_gate.py", "gadgets/range_gate.py",
    "gadgets/integer_chip.py", "gadgets/ecc_chip.py",
    "arith/circuit.py", "circuits/aggregator.py", "prover/mock.py",
    "solidity/ir.py", "solidity/chips.py", "solidity/transcript.py",
    "solidity/optimize.py", "solidity/aggregate.py", "solidity/generate.py",
    "solidity/linear_scan.py", "solidity/interpreter.py",
    "solidity/packed.py", "solidity/render.py", "solidity/syntax.py",
    "solidity/lint.py", "solidity/sol_exec.py",
    "circuits/shuffle.py", "circuits/synthetic.py", "arith/ast.py",
]


def _split_header(text: str) -> tuple[list[str], str]:
    lines = text.splitlines(keepends=True)
    n = 0
    while n < len(lines) and lines[n].startswith("#"):
        n += 1
    return lines[:n], "".join(lines[n:])


def _edits(header: list[str]) -> list[tuple[str, str]]:
    minus = [h[len("# edit- "):] for h in header if h.startswith("# edit- ")]
    plus = [h[len("# edit+ "):] for h in header if h.startswith("# edit+ ")]
    assert len(minus) == len(plus), "unpaired edit lines"
    return list(zip(minus, plus))


@pytest.mark.parametrize("rel", COPIES + ["csrc/bn254_native.cpp"])
def test_copy_equals_reference(rel):
    if rel == "csrc/bn254_native.cpp":
        assert ((PORT / rel).read_bytes()
                == (REPO / "native" / "bn254_native.cpp").read_bytes())
        return
    header, body = _split_header((PORT / rel).read_text())
    assert header and "halo2_snark_aggregator_tpu/" + rel in header[0]
    want = (REF / rel).read_text()
    for old, new in _edits(header):
        assert want.count(old) == 1, f"edit target not unique: {old!r}"
        want = want.replace(old, new)
    assert body == want
