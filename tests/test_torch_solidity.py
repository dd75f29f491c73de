"""The port's EVM verifier codegen (solidity/, sdk/harness.verify_solidity,
the CLI's verify_solidity) against the JAX package, on the CPU:

  * the same SHA-transcript proof (the JAX host prover's) gives the same
    statement count, both emitted sources byte for byte, and the same
    packed opcodes and constant pool, for SimpleMul (sha256 and
    keccak256), SimpleLookupCircuit and the zkevm-shape circuit at k = 7;
  * both sources, executed by the port's SolidityExecutor, accept each
    proof and reject a flipped proof word and a wrong instance;
  * the CLI's `verify_solidity --cpu` target flow writes verifier.sol and
    verifier_packed.sol byte-equal to the JAX CLI's, for both algos, over
    the JAX host prover's proof bytes; its outer flow too, over a proof of
    a circuit with the aggregator's constraint system (verify_final_pair
    accepting the stored target pair, rejecting another);
  * the JAX solidity tests' lint and syntax probes hold on the port's
    modules.
"""

import pytest

from halo2_snark_aggregator_tpu.circuits.lookup import SimpleLookupCircuit
from halo2_snark_aggregator_tpu.circuits.simple import SimpleMulCircuit
from halo2_snark_aggregator_tpu.circuits.zkevm import ZkevmShapeCircuit
from halo2_snark_aggregator_tpu.prover.keygen import keygen
from halo2_snark_aggregator_tpu.prover.kzg import ParamsKZG
from halo2_snark_aggregator_tpu.prover.prove import create_proof
from halo2_snark_aggregator_tpu.sdk import cli as jcli
from halo2_snark_aggregator_tpu.solidity.generate import generate as jgenerate
from halo2_snark_aggregator_tpu.solidity.packed import encode as jencode
from halo2_snark_aggregator_tpu.solidity.render import render as jrender
from halo2_snark_aggregator_tpu.solidity.render import render_packed as jrender_packed
from halo2_snark_aggregator_tpu.transcript.host import ShaWrite
from halo2_snark_aggregator_tpu.utils.store import FolderStore as JaxStore
from halo2_snark_aggregator_tpu_torch.circuits import lookup as plookup
from halo2_snark_aggregator_tpu_torch.circuits import simple as psimple
from halo2_snark_aggregator_tpu_torch.circuits import zkevm as pzkevm
from halo2_snark_aggregator_tpu_torch.ff import bn254 as ff
from halo2_snark_aggregator_tpu_torch.protocol.queryplan import (query_plan,
                                                                 rotation_sets)
from halo2_snark_aggregator_tpu_torch.prover import keygen as pkeygen
from halo2_snark_aggregator_tpu_torch.prover import kzg as pkzg
from halo2_snark_aggregator_tpu_torch.sdk import cli as pcli
from halo2_snark_aggregator_tpu_torch.sdk import harness
from halo2_snark_aggregator_tpu_torch.sdk.harness import solidity_verdict
from halo2_snark_aggregator_tpu_torch.solidity.generate import generate
from halo2_snark_aggregator_tpu_torch.solidity.interpreter import proof_to_words
from halo2_snark_aggregator_tpu_torch.solidity.lint import (SolidityLintError,
                                                            lint_source)
from halo2_snark_aggregator_tpu_torch.solidity.packed import encode
from halo2_snark_aggregator_tpu_torch.solidity.render import render, render_packed
from halo2_snark_aggregator_tpu_torch.solidity.syntax import (SoliditySyntaxError,
                                                              check_solidity)
from halo2_snark_aggregator_tpu_torch.utils.store import FolderStore

# case -> (JAX circuit, port circuit, k, transcript hash)
CASES = {
    "simple_sha256": (lambda: SimpleMulCircuit(3, 4),
                      lambda: psimple.SimpleMulCircuit(3, 4),
                      SimpleMulCircuit.K, "sha256"),
    "simple_keccak256": (lambda: SimpleMulCircuit(5, 6),
                         lambda: psimple.SimpleMulCircuit(5, 6),
                         SimpleMulCircuit.K, "keccak256"),
    "lookup_sha256": (lambda: SimpleLookupCircuit([1, 3, 5, 7, 11, 13, 3]),
                      lambda: plookup.SimpleLookupCircuit([1, 3, 5, 7, 11, 13, 3]),
                      SimpleLookupCircuit.K, "sha256"),
    "zkevm_k7_sha256": (lambda: ZkevmShapeCircuit(k=7, seed=3, n_groups=2,
                                                  table_bits=6),
                        lambda: pzkevm.ZkevmShapeCircuit(k=7, seed=3, n_groups=2,
                                                         table_bits=6),
                        7, "sha256"),
}


def _make(case):
    """The JAX host prover's proof and both packages' verifiers over it."""
    jbuild, pbuild, k, algo = CASES[case]
    params = ParamsKZG.unsafe_setup(k)
    c = jbuild()
    vk, pk = keygen(c, k, params)
    instances = c.instances()
    proof = create_proof(pk, params, [c], [instances], ShaWrite(algo), seed=7)
    jgen = jgenerate(vk, params, proof, instances, algo=algo)

    pparams = pkzg.ParamsKZG.unsafe_setup(k)
    pvk, _ppk = pkeygen.keygen(pbuild(), k, pparams)
    gen = generate(pvk, pparams, proof, instances, algo=algo)
    return dict(algo=algo, proof=proof, instances=instances, vk=pvk,
                jax=(jgen, params), port=(gen, pparams))


@pytest.fixture(scope="module", params=sorted(CASES))
def made(request):
    return _make(request.param)


def test_same_verifier_as_reference(made):
    jgen, params = made["jax"]
    gen, pparams = made["port"]
    assert gen.pairing_ok and jgen.pairing_ok
    assert len(gen.cg.statements) == len(jgen.cg.statements)
    assert gen.transcript_words == jgen.transcript_words
    assert render(gen, pparams) == jrender(jgen, params)
    assert render_packed(gen, pparams) == jrender_packed(jgen, params)
    prog, jprog = encode(gen), jencode(jgen)
    assert prog.ops == jprog.ops
    assert prog.cpool == jprog.cpool
    assert prog.memory_size == jprog.memory_size


def _flat(instances):
    return [v % ff.R for col in instances for v in col]


def test_sources_execute(made):
    """Both sources accept the proof, and reject it with the low bit of its
    last evaluation flipped (the word before the opening points)."""
    gen, pparams = made["port"]
    words = proof_to_words(made["proof"])
    flat = _flat(made["instances"])
    sets = rotation_sets(query_plan(made["vk"], 1))
    bad = list(words)
    bad[len(words) - 2 * len(sets) - 1] ^= 1
    for src in (render(gen, pparams), render_packed(gen, pparams)):
        check_solidity(src)
        assert solidity_verdict(src, made["algo"], words, flat) == "accepted"
        assert solidity_verdict(src, made["algo"], bad, flat) != "accepted"


@pytest.mark.parametrize("case", [c for c in sorted(CASES)
                                  if not c.startswith("lookup")])
def test_sources_reject_wrong_instance(case):
    made = _make(case)
    gen, pparams = made["port"]
    words = proof_to_words(made["proof"])
    flat = _flat(made["instances"])
    wrong = [(flat[0] + 1) % ff.R] + flat[1:]
    for src in (render(gen, pparams), render_packed(gen, pparams)):
        assert solidity_verdict(src, made["algo"], words, flat) == "accepted"
        assert solidity_verdict(src, made["algo"], words, wrong) != "accepted"


@pytest.mark.parametrize("algo", ["sha256", "keccak256"])
def test_cli_target_flow_matches_reference(tmp_path, algo):
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    for cmd in ("sample_setup", "sample_run"):
        assert jcli.main(["-c", cmd, "-f", str(jdir)]) == 0
        assert pcli.main(["-c", cmd, "-f", str(pdir), "--cpu"]) == 0
    assert jcli.main(["-c", "verify_solidity", "-f", str(jdir),
                      "--algo", algo]) == 0
    assert pcli.main(["-c", "verify_solidity", "-f", str(pdir), "--cpu",
                      "--algo", algo]) == 0
    for name in ("verifier.sol", "verifier_packed.sol"):
        src = (pdir / name).read_text()
        assert src == (jdir / name).read_text()
        assert f"{algo}(buf)" in src

    # the flow's proof, made on the prover's CPU twins, is the JAX host
    # prover's (seed 0)
    spec = pcli.demo_spec()
    run = harness.verify_solidity([spec], FolderStore(pdir), algo=algo,
                                  device="cpu")
    jstore = JaxStore(jdir)
    params = jstore.read_target_params(spec.name)
    _vk, pk = jstore.read_target_vkey(spec.name)
    c = SimpleMulCircuit(3, 4)  # the demo's circuit_builder(1)
    assert run.proof == create_proof(pk, params, [c], [c.instances()],
                                     ShaWrite(algo), seed=0)


HOLLOW_K = 8


def _hollow(agg_cls):
    """A circuit with the aggregation circuit's constraint system and no
    rows assigned: every gate, lookup and copy holds on zero columns, and
    its instance column is free. The codegen reads only the constraint
    system, so its verifier has the outer verifier's shape, at a k a CPU
    proves in a second (a real outer proof needs 2^20 rows or more)."""
    class Hollow(agg_cls):
        def synthesize(self, config, assignment):
            pass

    return Hollow([])


def test_cli_outer_flow_matches_reference(tmp_path, monkeypatch):
    """The outer flow over a stored proof of the hollow aggregator whose
    instances pack the demo's real final pair: both CLIs write the same
    sources, which accept the proof and, through verify_final_pair, the
    stored target pair; a wrong pair is rejected."""
    from halo2_snark_aggregator_tpu.circuits.aggregator import (
        AggregatorCircuit as JaxAggregator)
    from halo2_snark_aggregator_tpu.prover import srs as jsrs
    from halo2_snark_aggregator_tpu_torch.circuits.aggregator import AggregatorCircuit
    from halo2_snark_aggregator_tpu_torch.protocol.instances import (
        final_pair_to_instances)

    # the JAX CLI loads the SRS with the JAX setup_cached_accel, whose first
    # build jit-compiles for about a minute on a CPU; the codegen reads its
    # Lagrange and G2 points, which the host ParamsKZG of the same tau holds
    monkeypatch.setattr(jsrs, "setup_cached_accel",
                        lambda k, cache_dir=None: ParamsKZG.unsafe_setup(k))
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    for cmd in ("sample_setup", "sample_run", "verify_check"):
        assert jcli.main(["-c", cmd, "-f", str(jdir), "--cpu"]) == 0
        assert pcli.main(["-c", cmd, "-f", str(pdir), "--cpu"]) == 0
    jstore, pstore = JaxStore(jdir), FolderStore(pdir)
    w_x, w_g = pstore.read_final_pair()
    inner = [pstore.read_target_instance("simple", i)[0][0] for i in range(2)]
    instances = [final_pair_to_instances(w_x, w_g, inner)]

    params = ParamsKZG.unsafe_setup(HOLLOW_K)
    jhollow = _hollow(JaxAggregator)
    vk, pk = keygen(jhollow, HOLLOW_K, params)
    proof = create_proof(pk, params, [jhollow], [instances], ShaWrite("sha256"),
                         seed=0)
    pvk, _ppk = pkeygen.keygen(_hollow(AggregatorCircuit), HOLLOW_K,
                               pkzg.ParamsKZG.unsafe_setup(HOLLOW_K))
    for store, v in ((jstore, vk), (pstore, pvk)):
        store.write_verify_vkey(v)
        store.write_verify_proof(proof)
        store.write_verify_instance(instances)
    args = ["-c", "verify_solidity", "--agg-k", str(HOLLOW_K)]
    assert jcli.main(args + ["-f", str(jdir)]) == 0
    assert pcli.main(args + ["-f", str(pdir), "--cpu"]) == 0
    for name in ("verifier.sol", "verifier_packed.sol"):
        src = (pdir / name).read_text()
        assert src == (jdir / name).read_text()
        assert "function verify_final_pair(" in src

    run = harness.verify_solidity(pcli.demo_specs("simple"), pstore,
                                  agg_k=HOLLOW_K, device="cpu")
    assert run.proof == proof and run.final_pair == (w_x, w_g)
    for text in run.sources.values():
        assert solidity_verdict(text, "sha256", run.words, run.instances,
                                (w_x, w_g)) == "accepted"
        assert solidity_verdict(text, "sha256", run.words, run.instances,
                                (w_g, w_x)) != "accepted"


# the JAX solidity tests' negative probes (tests/test_solidity_lint.py:50-98,
# tests/test_solidity_codegen.py:177-193), on the port's modules
LINT_PROBES = {
    "out_of_grammar": (False, lambda s: s.replace(
        "bytes32 digest;", "bytes32 digest;\n        m[0] = proof[0] + 1;", 1),
        {}, "outside emitted grammar"),
    "forbidden": (False, lambda s: s.replace(
        "contract Verifier {", "contract Verifier {\n    function k() public "
        "{ selfdestruct(payable(msg.sender)); }", 1), {}, "forbidden"),
    "oversize_packed": (True, lambda s: s,
                        dict(has_body=False, packed_blob_bytes=30000), "EIP-170"),
}
SYNTAX_PROBES = {
    "unclosed_contract": lambda s: s.replace("contract Verifier {",
                                             "contract Verifier "),
    "odd_hex": lambda s: s.replace('hex"', 'hex"f', 1),
}


@pytest.fixture(scope="module")
def simple_sources():
    gen, pparams = _make("simple_sha256")["port"]
    prog = encode(gen)
    src, packed = render(gen, pparams), render_packed(gen, pparams)
    lint_source(src)
    lint_source(packed, has_body=False,
                packed_blob_bytes=len(prog.ops) + 32 * len(prog.cpool))
    return src, packed


@pytest.mark.parametrize("probe", sorted(LINT_PROBES))
def test_lint_probe(simple_sources, probe):
    packed, edit, kwargs, match = LINT_PROBES[probe]
    src = simple_sources[1 if packed else 0]
    with pytest.raises(SolidityLintError, match=match):
        lint_source(edit(src), **kwargs)


@pytest.mark.parametrize("probe", sorted(SYNTAX_PROBES))
def test_syntax_probe(simple_sources, probe):
    packed = simple_sources[1]
    check_solidity(packed)
    with pytest.raises(SoliditySyntaxError):
        check_solidity(SYNTAX_PROBES[probe](packed))
