"""Systems that stand in for the program under test: the control and the
planted faults that the comparison has to catch.

  * `RefVerifier`: the plain reference in the verifier's place. With no
    fault it is sound; `half` folds only the first half of each batch's
    lanes (the control of the verify cells: it breaks the guarantee that
    every lane is verified); `stale` hands back the first batch's answer
    for every batch (a step that returns its state unchanged); `altered`
    moves w_x by the generator (an answer altered where it is produced).
  * `FaultyProver`: any prover with a fault: `stale` hands back the first
    proof for every call; `altered` flips a bit of the last evaluation;
    `other` proves the next witness seed's circuit instead (a proof of
    another statement: the control of the prove cell).
  * `FixtureProver`: the committed proofs for the witness seeds they were
    made with, for runs without a card.
"""

from __future__ import annotations

import time

from portbench.reference import bn254 as ff
from portbench.reference import check as ref

VERIFY_FAULTS = ("none", "half", "stale", "altered")
PROVE_FAULTS = ("none", "stale", "altered", "other")


class RefVerifier:
    def __init__(self, cfg: dict, proofs: list, fault: str = "none"):
        if fault not in VERIFY_FAULTS:
            raise ValueError(fault)
        self.fault = fault
        self.prm = ref.params(cfg["k"], cfg["srs_seed"],
                              max(len(c) for _p, inst in proofs for c in inst))
        self.results = ref.verify_many(cfg["k"], cfg["n_groups"],
                                       cfg["fingerprint"], self.prm, proofs)
        self.first = None
        self.last_profile: dict = {}

    def verify(self, lanes: list):
        if self.fault == "half":
            lanes = lanes[: len(lanes) // 2]
        out = ref.aggregate(self.results, lanes, self.prm)
        if self.fault == "stale":
            self.first = self.first or out
            return self.first
        if self.fault == "altered":
            return ff.g1_add(out[0], ff.G1_GEN), out[1], out[2]
        return out

    def close(self) -> None:
        pass


class FaultyProver:
    def __init__(self, inner, fault: str):
        if fault not in PROVE_FAULTS:
            raise ValueError(fault)
        self.inner, self.fault, self.first = inner, fault, None

    def close(self) -> None:
        self.inner.close()

    def prove(self, seeds: tuple) -> bytes:
        if self.fault == "other":
            seeds = (seeds[0] + 1, seeds[1])
        proof = self.inner.prove(seeds)
        if self.fault == "stale":
            self.first = self.first or proof
            return self.first
        if self.fault == "altered":
            b = bytearray(proof)
            b[-32] ^= 1
            return bytes(b)
        return proof


class FixtureProver:
    """Proofs of the committed fixtures by witness seed (the lines of
    program.fixture_lines), each after `delay` seconds, as a prover would
    take some."""

    def __init__(self, lines: list, delay: float = 0.05):
        self.by_seed = {d["witness_seed"]: bytes.fromhex(d["proof"])
                        for d in lines}
        self.delay = delay
        self.timer = None
        self.scalars = None

    def prove(self, seeds: tuple) -> bytes:
        time.sleep(self.delay)
        return self.by_seed[seeds[0]]

    def close(self) -> None:
        pass
