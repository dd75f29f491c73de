"""The rest of a run, with the timed path broken underneath, comes out
not correct: the harness's look for a card is skipped and a stand-in
system takes the program's place. Sound stand-ins come out correct.

The verify cells run here over the first 8 committed proofs, and the
reference's verdicts on them are read once, so the CPU run stays short."""

import functools
import itertools
import time

import pytest

from portbench import faults, harness, program, traffic
from portbench.reference import check as ref

POOL = 8
ALL_PROOFS = program.fixture_proofs
VERIFY_MANY = ref.verify_many


@functools.lru_cache(maxsize=None)
def _pool():
    return ALL_PROOFS(c_cfg())[:POOL]


@functools.lru_cache(maxsize=None)
def _verified(k, n_groups, fp, n):
    proofs = _pool()[:n]
    prm = ref.params(k, c_cfg()["srs_seed"],
                     max(len(c) for _p, inst in proofs for c in inst))
    return tuple(VERIFY_MANY(k, n_groups, fp, prm, proofs))


def c_cfg():
    return harness.find_cell("zkevm16.verify.b8").config


@pytest.fixture
def small_pool(monkeypatch):
    monkeypatch.setattr(program, "fixture_proofs", lambda cfg: list(_pool()))
    monkeypatch.setattr(ref, "verify_many", lambda k, g, fp, prm, items: list(
        _verified(k, g, fp, len(items))))


def run_verify(fault, cell="zkevm16.verify.b8", seconds=0.5):
    c = harness.find_cell(cell)
    system = faults.RefVerifier(c.config, program.fixture_proofs(c.config), fault)
    return harness.entry_module(c).run(c, 4242, seconds, False,
                                       time.perf_counter(), system=system)


@pytest.mark.parametrize("fault,correct", [("none", True), ("half", False),
                                           ("stale", False), ("altered", False)])
def test_verify_faults(fault, correct, small_pool):
    out = run_verify(fault)
    assert out.correct is correct, out.checks
    assert (out.failed == 0) is correct
    assert out.attempted >= 2


def test_reference_over_workers_equals_one_process():
    proofs = _pool()[:2]
    cfg = c_cfg()
    prm = ref.params(cfg["k"], cfg["srs_seed"], 1)
    vk = ref.load_key(cfg["k"], cfg["n_groups"], cfg["fingerprint"])
    many = ref.verify_many(cfg["k"], cfg["n_groups"], cfg["fingerprint"], prm,
                           proofs)
    assert many == [ref.verify_proof(vk, prm, p, inst) for p, inst in proofs]
    batches = [[0, 1], [1, 0]]
    assert ref.aggregate_many(many, batches, prm) == [
        ref.aggregate(many, lanes, prm) for lanes in batches]


def run_prove(fault, monkeypatch, seconds=0.2):
    c = harness.find_cell("zkevm16.prove")
    lines = program.fixture_lines(c.config)[:4]
    # the committed proofs' own seeds (the first three, so that the `other`
    # fault's next witness seed has a proof too)
    seeds = [(d["witness_seed"], d["blinding_seed"]) for d in lines[:3]]
    monkeypatch.setattr(traffic, "circuit_draws",
                        lambda seed, name: itertools.cycle(seeds))
    system = faults.FaultyProver(faults.FixtureProver(lines), fault)
    return harness.entry_module(c).run(c, 4242, seconds, False,
                                       time.perf_counter(), system=system)


@pytest.mark.parametrize("fault,correct", [("none", True), ("stale", False),
                                           ("altered", False), ("other", False)])
def test_prove_faults(fault, correct, monkeypatch):
    out = run_prove(fault, monkeypatch)
    assert out.correct is correct, out.checks
    assert out.attempted >= 2
