# Copy of halo2_snark_aggregator_tpu/solidity/syntax.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""Structural syntax validation of generated Solidity (no solc in the image).

Not a compiler — a tokenizer-level well-formedness check that catches the
codegen bug classes that actually occur (unbalanced braces from template
holes, truncated statements, malformed hex literals, undeclared memory
arrays), so a broken verifier.sol fails in CI instead of at deployment.
The reference's equivalent gate is the waffle harness compiling + deploying
the contract (D9, waffle/test/Verifier.test.ts); this is the strongest
check available without solc/node.
"""

from __future__ import annotations

import re


class SoliditySyntaxError(ValueError):
    pass


def _strip(src: str) -> str:
    """Remove comments and string literals (keeping newlines for line nos)."""
    out = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if src.startswith("//", i):
            j = src.find("\n", i)
            i = n if j == -1 else j
        elif src.startswith("/*", i):
            j = src.find("*/", i)
            if j == -1:
                raise SoliditySyntaxError("unterminated block comment")
            out.append("\n" * src.count("\n", i, j))
            i = j + 2
        elif c == '"':
            j = src.find('"', i + 1)
            if j == -1:
                raise SoliditySyntaxError("unterminated string literal")
            out.append('""')
            i = j + 1
        else:
            out.append(c)
            i += 1
    return "".join(out)


def check_solidity(src: str) -> None:
    """Raises SoliditySyntaxError on structural problems."""
    body = _strip(src)

    if "pragma solidity" not in body:
        raise SoliditySyntaxError("missing pragma")
    if not re.search(r"\bcontract\s+\w+\s*\{", body):
        raise SoliditySyntaxError("missing contract declaration")

    # balanced delimiters with proper nesting
    stack = []
    pairs = {")": "(", "]": "[", "}": "{"}
    line = 1
    for ch in body:
        if ch == "\n":
            line += 1
        elif ch in "([{":
            stack.append((ch, line))
        elif ch in ")]}":
            if not stack or stack[-1][0] != pairs[ch]:
                raise SoliditySyntaxError(
                    f"unbalanced {ch!r} at line {line}")
            stack.pop()
    if stack:
        raise SoliditySyntaxError(
            f"unclosed {stack[-1][0]!r} opened at line {stack[-1][1]}")

    # hex literals well-formed (even length, hex digits only)
    for m in re.finditer(r'hex"([^"]*)"', src):
        h = m.group(1)
        if len(h) % 2 != 0 or not re.fullmatch(r"[0-9a-fA-F]*", h):
            raise SoliditySyntaxError(f"malformed hex literal ({h[:16]}...)")

    # every non-block line inside the contract ends with ; { or }
    in_assembly = 0
    paren_depth = 0
    for lineno, raw in enumerate(body.splitlines(), 1):
        s = raw.strip()
        depth_before = paren_depth
        paren_depth += s.count("(") - s.count(")")
        if not s:
            continue
        if depth_before > 0 or paren_depth > 0:
            continue  # inside a multi-line parenthesized list
        if "assembly" in s:
            in_assembly += s.count("{") - s.count("}")
            continue
        if in_assembly > 0:
            in_assembly += s.count("{") - s.count("}")
            continue
        if s.startswith(("pragma", "//", "import")):
            if not s.endswith(";") and s.startswith(("pragma", "import")):
                raise SoliditySyntaxError(f"line {lineno}: missing semicolon")
            continue
        if s.endswith((";", "{", "}", ")", ",")) or s.startswith(
                ("contract", "function", "for", "if", "else", "while",
                 "return", "struct")):
            continue
        # multi-line expressions (continuations) end with operators
        if s.endswith(("&&", "||", "+", "-", "*", "=", "(")):
            continue
        raise SoliditySyntaxError(f"line {lineno}: suspicious statement {s!r}")

    # referenced identifiers that must be declared somewhere
    for ident in ("R_MOD", "Q_MOD"):
        uses = len(re.findall(rf"\b{ident}\b", body))
        decls = len(re.findall(rf"uint256\s+constant\s+{ident}\b", body))
        if uses and not decls:
            raise SoliditySyntaxError(f"{ident} used but never declared")
