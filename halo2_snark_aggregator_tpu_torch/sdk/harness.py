"""Target-circuit harness and the zkaggregate! stages on the card.

Port of halo2_snark_aggregator_tpu/sdk/harness.py. `TargetCircuitSpec`
mirrors the reference's TargetCircuit trait; each stage round-trips its
artifacts through the FolderStore (utils/store.py), so any stage can be
re-run on its own. Every stage takes a `device`, the card by default; the
CPU only when a caller asks for it (every kernel then runs its plain
twin):

  * sample_setup / sample_run: the target circuit's params are the host
    `ParamsKZG` (cached under the port's `_cache/`); keygen and proofs run
    through the accelerated prover on `AccelParams.from_params(params)`;
    each proof self-verifies on values, as in the reference;
  * verify_check: the aggregation verifier on the hybrid chips
    (arith/device_value.py), the final pair stored;
  * verify_setup / verify_run: the aggregation circuit's keygen and its
    outer proof (SHA-256 transcript) at `agg_k` on the accelerated SRS
    (`setup_cached_accel`); verify_check_outer checks the stored outer
    proof on values;
  * verify_solidity: the EVM verifier (solidity/) generated over the stored
    outer proof, or over a demo target proof made on `device` with the
    SHA-256 or Keccak-256 transcript; both emitted sources are checked,
    linted, written and executed on the proof;
  * the second recursion layer: verify_check_l1_poseidon checks a
    Poseidon-transcript layer-1 outer proof on values, verify2_run proves
    it inside a second aggregation circuit into another store,
    verify2_check checks that layer-2 proof.

The store holds host forms only, so every file it writes loads with no card
and without the JAX package: the `ParamsKZG`, the vk, and the proving
key's columns as numpy Montgomery words (uploaded at use). Pickles written
by the JAX package name its classes, so this harness never reads one; the
raw proofs and the int-list instance and final-pair files are the same
format in both.

The reference's `spill=` argument is dropped (the port has no spill mode;
prover/accel.py).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from .. import device as dv
from ..arith.device_value import make_device_chips
from ..fixtures import vk_fingerprint
from ..arith.value import ValueContext, ValueEccChip
from ..ops import field as fo
from ..protocol import verify as pv
from ..protocol.transcript import PoseidonTranscriptRead
from ..prover.accel import (AccelParams, AccelPk, create_proof_accel,
                            keygen_accel)
from ..prover.domain import Domain
from ..prover.keygen import Assignment
from ..prover.kzg import ParamsKZG
from ..prover.srs import CACHE_DIR, setup_cached_accel
from ..transcript.host import PoseidonWrite
from ..utils.store import FolderStore

log = logging.getLogger(__name__)

PK_KEYS = ("fl", "fc", "sl", "sc")  # the reference checkpoint's names


@dataclasses.dataclass
class TargetCircuitSpec:
    name: str
    k: int
    n_proofs: int
    public_input_size: int
    circuit_builder: Callable[[int], object]  # seed -> Circuit with witness
    instance_builder: Callable[[object], list]  # circuit -> [col][row] values


# -- host forms of the proving key ---------------------------------------------


def pk_columns(apk: AccelPk) -> dict[str, np.ndarray]:
    """The proving key's columns as host uint32 (ncols, n, 8) Montgomery
    words: fixed Lagrange and coefficient forms, sigma Lagrange and
    coefficient forms."""
    n = apk.domain.n
    out = {}
    for key, cols in zip(PK_KEYS, (apk.fixed_lagrange, apk.fixed_coeff,
                                   apk.sigmas_lagrange, apk.sigmas_coeff)):
        out[key] = (fo.to_numpy(torch.stack(cols)) if cols
                    else np.zeros((0, n, fo.WORDS), np.uint32))
    return out


def pk_from_columns(vk, cols: dict, device) -> AccelPk:
    """An AccelPk on `device` from `pk_columns`' arrays."""
    dev = dv.resolve(device)

    def up(key):
        return list(fo.to_tensor(cols[key], dev).unbind(0))

    return AccelPk(vk, Domain(vk.k), *(up(key) for key in PK_KEYS))


# -- target-circuit stages -------------------------------------------------------


def sample_setup(spec: TargetCircuitSpec, store: FolderStore, device="cuda"):
    """Params + vk for the target circuit (sample_circuit.rs:42-67); the
    key is built by the accelerated keygen on `device`."""
    dev = dv.resolve(device)
    params = ParamsKZG.setup_cached(spec.k, cache_dir=CACHE_DIR)
    aparams = AccelParams.from_params(params, device=dev)
    circuit = spec.circuit_builder(0)
    vk, apk = keygen_accel(circuit, spec.k, aparams)
    store.write_target_params(spec.name, params)
    store.write_target_vkey(spec.name, (vk, pk_columns(apk)))
    log.info("sample_setup(%s): k=%d done on %s", spec.name, spec.k, dev)


def sample_run(spec: TargetCircuitSpec, store: FolderStore, device="cuda"):
    """N_PROOFS proofs on `device`, each self-verified on values
    (sample_circuit.rs:69-124)."""
    dev = dv.resolve(device)
    params = store.read_target_params(spec.name)
    vk, cols = store.read_target_vkey(spec.name)
    aparams = AccelParams.from_params(params, device=dev)
    apk = pk_from_columns(vk, cols, dev)
    for i in range(spec.n_proofs):
        circuit = spec.circuit_builder(i + 1)
        instances = spec.instance_builder(circuit)
        proof = create_proof_accel(apk, aparams, [circuit], [instances],
                                   PoseidonWrite(), seed=i)
        # immediate self-verification on the value context
        ctx = ValueContext()
        pchip = ValueEccChip()
        nchip = schip = pchip.scalar_chip
        t = PoseidonTranscriptRead(proof, ctx, nchip)
        cp = pv.CircuitProof(
            name=spec.name, vk=vk, params=params,
            proofs=[pv.ProofData(instances=[instances], transcript=t,
                                 key=f"{spec.name}_{i}")],
        )
        *_, ok = pv.verify_single_proof_in_chip(ctx, nchip, schip, pchip, cp)
        if not ok:
            raise RuntimeError(f"self-verification failed for proof {i}")
        store.write_target_proof(spec.name, i, proof)
        store.write_target_instance(spec.name, i, instances)
        log.info("sample_run(%s): proof %d ok (%d bytes)", spec.name, i, len(proof))


def verify_check(specs: list[TargetCircuitSpec], store: FolderStore,
                 device="cuda", group=None):
    """Aggregate-verify every stored proof on the hybrid chips and store the
    final pair (calc_verify_circuit_final_pair, verify_circuit.rs:103-201).
    With a torch.distributed `group` (the reference's `mesh=`) every rank
    runs this call, the device MSMs are sharded over the ranks, each rank
    returns the same pair and rank 0 of the group stores it."""
    ctx, nchip, schip, pchip = make_device_chips(device, group=group)

    circuits = []
    for spec in specs:
        params = store.read_target_params(spec.name)
        vk, _cols = store.read_target_vkey(spec.name)
        proofs = []
        for i in range(spec.n_proofs):
            proof = store.read_target_proof(spec.name, i)
            instances = store.read_target_instance(spec.name, i)
            t = PoseidonTranscriptRead(proof, ctx, nchip)
            proofs.append(
                pv.ProofData(instances=[instances], transcript=t, key=f"{spec.name}_{i}")
            )
        circuits.append(pv.CircuitProof(name=spec.name, vk=vk, params=params,
                                        proofs=proofs))

    agg_transcript = PoseidonTranscriptRead(b"", ctx, nchip)
    w_x, w_g, plain_instances, _commits, ok = pv.verify_aggregation_proofs_in_chip(
        ctx, nchip, schip, pchip, circuits, agg_transcript
    )
    if not ok:
        raise RuntimeError("aggregated pairing check failed")
    if group is None or dist.get_rank(group) == 0:
        store.write_final_pair(w_x, w_g)
    log.info("verify_check: %d circuits aggregated, final pair stored; ctx=%s",
             len(circuits), ctx)
    return w_x, w_g, plain_instances


# -- outer-proof stages (verify_circuit.rs:644-765, 898-1010, 1012-1055) ---------


def _load_targets(specs: list[TargetCircuitSpec], store: FolderStore):
    from ..circuits.aggregator import SingleProofWitness, VerifierCircuitTarget

    targets = []
    for spec in specs:
        params = store.read_target_params(spec.name)
        vk, _cols = store.read_target_vkey(spec.name)
        proofs = []
        for i in range(spec.n_proofs):
            proofs.append(SingleProofWitness(
                instances=store.read_target_instance(spec.name, i),
                transcript=store.read_target_proof(spec.name, i)))
        targets.append(VerifierCircuitTarget(
            name=spec.name, vk=vk, params=params, proofs=proofs))
    return targets


def _agg_params(agg_k: int, device, params: AccelParams | None) -> AccelParams:
    """The accelerated SRS at agg_k (`setup_cached_accel`, cached under the
    port's `_cache/`), or the caller's own: the stages take `params` for a
    caller that holds the SRS already and reads its `commit_log`, as
    chip_smoke.py does; the CLI passes none."""
    if params is not None:
        if params.k != agg_k:
            raise ValueError(f"params are for k={params.k}, not {agg_k}")
        return params
    return setup_cached_accel(agg_k, device=device)


def verify_setup(specs: list[TargetCircuitSpec], store: FolderStore,
                 agg_k: int = 22, device="cuda", timer=None,
                 params: AccelParams | None = None):
    """Aggregation-circuit keygen on `device` (MultiCircuitsSetup::call).
    Stores the aggregator vkey; as in the reference, verify_run keygens the
    proving key again (verify_circuit.rs:974-979). `timer` (a StageTimer)
    splits keygen's time; `params` (the SRS at agg_k) saves loading it."""
    from ..circuits.aggregator import AggregatorCircuit

    aparams = _agg_params(agg_k, device, params)
    agg = AggregatorCircuit(_load_targets(specs, store))
    vk, _apk = keygen_accel(agg, agg_k, aparams, timer=timer)
    store.write_verify_vkey(vk)
    log.info("verify_setup: aggregator vkey at k=%d stored", agg_k)
    return vk


def verify_run(specs: list[TargetCircuitSpec], store: FolderStore,
               agg_k: int = 22, seed: int = 0, transcript: str = "sha",
               device="cuda", timer=None, keygen_timer=None,
               params: AccelParams | None = None):
    """The outer aggregation proof on `device` (MultiCircuitsCreateProof::
    call): the value context's final pair -> the 136-bit instance packing ->
    aggregator keygen (or its checkpoint) -> the accelerated proof with the
    SHA-256 transcript, so an EVM verifier can recompute the challenges
    (verify_circuit.rs:984-995); transcript="poseidon" for a proof that
    feeds a second recursion layer. `timer` and `keygen_timer`
    (StageTimers) split the proof's and keygen's time; `params` (the SRS at
    agg_k) saves loading it."""
    from ..circuits.aggregator import AggregatorCircuit

    agg = AggregatorCircuit(_load_targets(specs, store))
    return _prove_aggregator(agg, store, agg_k, seed, transcript, device,
                             timer, keygen_timer, params)


def checkpoint_paths(store: FolderStore, agg_k: int):
    """The keygen checkpoint (the proving key's columns, npz) and its shape
    sidecar (json)."""
    return (store._path(f"verify_circuit_apk_k{agg_k}.npz"),
            store._path(f"verify_circuit_apk_k{agg_k}.shape.json"))


def _replace_into(path, write) -> None:
    """write(f) into a temp file beside `path`, then os.replace it into
    place: a killed write leaves the old file or none, never a torn one."""
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    try:
        with open(tmp, "wb") as f:
            write(f)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def write_checkpoint(store: FolderStore, agg_k: int, apk: AccelPk,
                     shape: dict) -> None:
    """The proving key's columns as host numpy, then the sidecar, each
    written atomically. Both name the aggregator `shape` and the
    fingerprint of the key's vk. The npz holds them too: a run killed
    between the two writes leaves a sidecar that no longer names the npz's
    key, and the npz's own copy decides."""
    path, fp_path = checkpoint_paths(store, agg_k)
    meta = json.dumps(dict(shape, vk=vk_fingerprint(apk.vk)))
    cols = pk_columns(apk)
    _replace_into(path, lambda f: np.savez(f, shape=np.array(meta), **cols))
    _replace_into(fp_path, lambda f: f.write(meta.encode()))


def load_checkpoint(store: FolderStore, agg_k: int, shape: dict,
                    device) -> AccelPk | None:
    """The checkpointed AccelPk on `device` with the stored vkey, or None
    when there is no checkpoint or vkey, or the checkpoint was keygen'd for
    another aggregator `shape` (its target vks included) or for another vk
    than the stored one: such a key misaligns the fixed columns against a
    fresh synthesis, or belongs to another vkey."""
    path, fp_path = checkpoint_paths(store, agg_k)
    if not (path.exists() and store.exists("verify_circuit.vkey")):
        return None
    vk = store.read_verify_vkey()
    want = dict(shape, vk=vk_fingerprint(vk))
    if fp_path.exists():
        saved = json.loads(fp_path.read_text())
        if saved != want:
            log.warning("verify_run: keygen checkpoint sidecar names %s, not "
                        "%s; re-running keygen", saved, want)
            return None
    with np.load(path) as data:
        saved = json.loads(str(data["shape"])) if "shape" in data else None
        if saved != want:
            log.warning("verify_run: keygen checkpoint holds %s, not %s; "
                        "re-running keygen", saved, want)
            return None
        cols = {key: data[key] for key in PK_KEYS}
    log.info("verify_run: reusing checkpointed keygen (%s)", path.name)
    return pk_from_columns(vk, cols, device)


def aggregator_shape(agg) -> dict:
    """What a keygen checkpoint is valid for: the aggregator's targets, its
    proofs a target, and its targets' vk fingerprints (their fixed
    columns are constants of the aggregator's)."""
    return {"n_targets": len(agg.circuits),
            "n_proofs": [len(t.proofs) for t in agg.circuits],
            "targets": [vk_fingerprint(t.vk) for t in agg.circuits]}


def smallest_k(assignment: Assignment) -> int:
    """The least k whose usable rows hold every row `assignment` touched."""
    blinding = assignment.n - assignment.usable_rows
    k = 1
    while (1 << k) - blinding <= assignment.max_row_touched:
        k += 1
    return k


def _prove_aggregator(agg, store: FolderStore, agg_k: int, seed: int,
                      transcript: str, device="cuda", timer=None,
                      keygen_timer=None, params: AccelParams | None = None,
                      assignment: Assignment | None = None):
    from ..protocol.instances import final_pair_to_instances
    from ..transcript.host import ShaWrite

    aparams = _agg_params(agg_k, device, params)

    w_x, w_g, plain = agg.calc_final_pair()
    instances = [final_pair_to_instances(w_x, w_g, plain)]
    store.write_final_pair(w_x, w_g)
    store.write_verify_instance(instances)

    # checkpoint the (expensive) aggregator keygen so a crashed prove phase
    # resumes without repaying it (the reference's condition, agg_k >= 18),
    # valid only for the exact aggregator it was keygen'd for: its shape,
    # its targets' vks (embedded in its fixed columns) and the stored vkey
    checkpoint = agg_k >= 18
    shape = aggregator_shape(agg)
    apk = load_checkpoint(store, agg_k, shape, aparams.device) if checkpoint else None
    if apk is None:
        vk, apk = keygen_accel(agg, agg_k, aparams, assignment=assignment,
                               timer=keygen_timer)
        store.write_verify_vkey(vk)
        if checkpoint:
            t0 = time.perf_counter()
            write_checkpoint(store, agg_k, apk, shape)
            log.info("verify_run: keygen checkpoint written (%.1f s)",
                     time.perf_counter() - t0)
    writer = PoseidonWrite() if transcript == "poseidon" else ShaWrite()
    proof = create_proof_accel(apk, aparams, [agg], [instances], writer,
                               seed=seed, timer=timer)
    store.write_verify_proof(proof)
    log.info("verify_run: outer proof %d bytes at k=%d (%s transcript)",
             len(proof), agg_k, transcript)
    return proof, instances


def verify_check_outer(store: FolderStore, agg_k: int = 22, device="cuda",
                       params: AccelParams | None = None):
    """Verify the stored outer proof on values (VerifyCheck::call,
    verify_circuit.rs:1032-1055) with the SHA-256 transcript reader, over
    the accelerated SRS's verifier points."""
    from ..protocol.transcript import ShaTranscriptRead

    aparams = _agg_params(agg_k, device, params)
    if not _verify_stored_on_values(store, aparams, ShaTranscriptRead,
                                    "verify_circuit"):
        raise RuntimeError("outer proof failed native verification")
    log.info("verify_check_outer: outer proof verified")
    return True


# -- the EVM verifier (SolidityGenerate::call, sdk/src/lib.rs) ------------------


@dataclasses.dataclass
class SolidityRun:
    """What verify_solidity made and checked: the generated verifier, the
    packed program, both emitted sources by file name, the proof and its
    calldata words, the flat instance words, the stored target final pair
    (the outer flow) and the seconds of each step."""

    gen: object
    prog: object
    sources: dict
    proof: bytes
    words: list
    instances: list
    final_pair: tuple | None
    seconds: dict


def solidity_verdict(source: str, algo: str, words: list, instances: list,
                     final_pair: tuple | None = None) -> str:
    """Execute an emitted verifier source on calldata: "accepted",
    "rejected" (verify returned false) or "reverted: <reason>". With a
    target final pair, verify_final_pair is executed instead: the contract
    packs the pair into the leading four instance words itself
    (verifier.sol:356-365)."""
    from ..solidity.sol_exec import SolidityExecutor, _Revert

    ex = SolidityExecutor(source, algo)
    try:
        if final_pair is None:
            ok = ex.verify(words, instances)
        else:
            w_x, w_g = final_pair
            ok = ex.call("verify_final_pair",
                         [list(words), [*w_x, *w_g], list(instances[4:])])
    except _Revert as e:
        return f"reverted: {e}"
    return "accepted" if ok else "rejected"


def verify_solidity(specs: list[TargetCircuitSpec], store: FolderStore,
                    agg_k: int = 22, algo: str = "sha256", device="cuda",
                    params: AccelParams | None = None) -> SolidityRun:
    """Generate the EVM verifier (the reference CLI's verify_solidity).
    With an outer proof in the store (the production flow): over that
    proof, its vk and instances, with the SRS at `agg_k` (`params`, or the
    cached one) and the targets' G2 points for the inner final-pair check.
    Otherwise over a demo target proof made on `device` with
    `ShaWrite(algo)` (seed 0). Both sources are syntax-checked, linted,
    written (verifier.sol, verifier_packed.sol) and executed on the proof;
    in the outer flow verify_final_pair is executed on the stored target
    final pair too. A rejection raises."""
    from ..ff import bn254 as ff
    from ..solidity.generate import generate
    from ..solidity.interpreter import proof_to_words
    from ..solidity.lint import lint_source
    from ..solidity.packed import encode as encode_packed
    from ..solidity.render import render, render_packed
    from ..solidity.syntax import check_solidity
    from ..transcript.host import ShaWrite

    spec = specs[0]
    seconds = {}
    final_pair = target_params = None
    t0 = time.perf_counter()
    if store.exists("verify_circuit_proof.data"):
        if algo != "sha256":
            raise ValueError("stored outer proofs use the sha256 transcript "
                             "(harness.verify_run)")
        vk = store.read_verify_vkey()
        proof = store.read_verify_proof()
        instances = store.read_verify_instance()
        params = _agg_params(agg_k, device, params)
        if sum(map(len, instances)) > len(params.g_lagrange):
            raise ValueError(f"{sum(map(len, instances))} instances, but the "
                             f"SRS holds {len(params.g_lagrange)} Lagrange "
                             f"points")
        # the inner final pair is pairing-checked on chain against the
        # target circuits' G2 points (verifier.sol:388-397)
        target_params = store.read_target_params(spec.name)
        final_pair = store.read_final_pair()
        seconds["load"] = time.perf_counter() - t0
    else:
        dev = dv.resolve(device)
        params = store.read_target_params(spec.name)
        vk, cols = store.read_target_vkey(spec.name)
        circuit = spec.circuit_builder(1)
        instances = spec.instance_builder(circuit)
        proof = create_proof_accel(pk_from_columns(vk, cols, dev),
                                   AccelParams.from_params(params, device=dev),
                                   [circuit], [instances], ShaWrite(algo),
                                   seed=0)
        seconds["prove"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    gen = generate(vk, params, proof, instances, algo=algo)
    seconds["generate"] = time.perf_counter() - t0
    if not gen.pairing_ok:
        raise RuntimeError("the generated verifier's own run failed the pairing")
    t0 = time.perf_counter()
    src = render(gen, params, target_params=target_params)
    src_packed = render_packed(gen, params, target_params=target_params)
    prog = encode_packed(gen)
    seconds["render"] = time.perf_counter() - t0
    check_solidity(src)
    lint_source(src)
    check_solidity(src_packed)
    lint_source(src_packed, has_body=False,
                packed_blob_bytes=len(prog.ops) + 32 * len(prog.cpool))
    store.write_solidity(src)
    store.write_solidity(src_packed, "verifier_packed.sol")

    # execute both emitted sources on the proof: the reference's deploy and
    # call (Verifier.test.ts:39-71) without a Solidity toolchain
    words = proof_to_words(proof)
    flat = [v % ff.R for col in instances for v in col]
    sources = {"verifier.sol": src, "verifier_packed.sol": src_packed}
    for name, text in sources.items():
        t0 = time.perf_counter()
        verdict = solidity_verdict(text, gen.algo, words, flat)
        seconds[f"execute {name}"] = time.perf_counter() - t0
        if verdict != "accepted":
            raise RuntimeError(f"{name} {verdict} the proof it was generated "
                               f"from")
        if final_pair is not None:
            t0 = time.perf_counter()
            verdict = solidity_verdict(text, gen.algo, words, flat, final_pair)
            seconds[f"final pair {name}"] = time.perf_counter() - t0
            if verdict != "accepted":
                raise RuntimeError(f"{name} verify_final_pair {verdict} the "
                                   f"stored target final pair")
    log.info("verify_solidity: %d statements, %d proof words, %d B opcode "
             "blob + %d B constant pool", len(gen.cg.statements),
             gen.transcript_words, len(prog.ops), 32 * len(prog.cpool))
    return SolidityRun(gen=gen, prog=prog, sources=sources, proof=proof,
                       words=words, instances=flat, final_pair=final_pair,
                       seconds=seconds)


# -- the second recursion layer ----------------------------------------------------
# The reference's "Multi-layer aggregator" future work: a layer-1 outer
# proof made with the Poseidon transcript becomes the target of another
# aggregation circuit.


def _verify_stored_on_values(store: FolderStore, aparams: AccelParams,
                             read, name: str) -> bool:
    """The value verifier over a store's outer proof, vk and instances."""
    ctx = ValueContext()
    pchip = ValueEccChip()
    nchip = schip = pchip.scalar_chip
    t = read(store.read_verify_proof(), ctx, nchip)
    cp = pv.CircuitProof(
        name=name, vk=store.read_verify_vkey(), params=aparams,
        proofs=[pv.ProofData(instances=[store.read_verify_instance()],
                             transcript=t, key=f"{name}_0")])
    *_, ok = pv.verify_single_proof_in_chip(ctx, nchip, schip, pchip, cp)
    return ok


def verify_check_l1_poseidon(store: FolderStore, agg_k: int, device="cuda",
                             params: AccelParams | None = None):
    """Verify a Poseidon-transcript layer-1 outer proof on values: the
    protocol the layer-2 circuit runs in-circuit."""
    aparams = _agg_params(agg_k, device, params)
    if not _verify_stored_on_values(store, aparams, PoseidonTranscriptRead,
                                    "verify_circuit_l1"):
        raise RuntimeError("layer-1 poseidon proof failed native verification")
    log.info("verify_check_l1_poseidon: layer-1 proof verified on values")
    return True


def layer2_target(l1_store: FolderStore, l1_params):
    """The layer-2 aggregator's one target: the stored layer-1 vk, proof
    and instances over the layer-1 SRS."""
    from ..circuits.aggregator import SingleProofWitness, VerifierCircuitTarget

    return VerifierCircuitTarget(
        name="verify_circuit_l1", vk=l1_store.read_verify_vkey(),
        params=l1_params,
        proofs=[SingleProofWitness(instances=l1_store.read_verify_instance(),
                                   transcript=l1_store.read_verify_proof())])


def verify2_run(l1_store: FolderStore, l2_store: FolderStore,
                l1_k: int | None = None, l2_k: int = 22, seed: int = 1,
                transcript: str = "sha", device="cuda", timer=None,
                keygen_timer=None, params: AccelParams | None = None,
                l1_params: AccelParams | None = None,
                assignment: Assignment | None = None):
    """Layer 2: the stored layer-1 outer proof (Poseidon transcript),
    verified inside a new aggregation circuit proved at `l2_k` on `device`
    into `l2_store` (SHA-256 transcript by default, EVM-checkable).
    `l1_k` defaults to the stored layer-1 vk's k, and must equal it;
    `params` and `l1_params` are the SRS at l2_k and l1_k (else the cached
    ones), `assignment` a keygen synthesis of this circuit at l2_k
    (`prover.accel.synthesize_keygen`) that keygen reuses."""
    from ..circuits.aggregator import AggregatorCircuit

    l1_vk_k = l1_store.read_verify_vkey().k
    if l1_k is None:
        l1_k = l1_vk_k
    if l1_k != l1_vk_k:
        raise ValueError(f"the layer-1 proof is at k={l1_vk_k}, not {l1_k}")
    l1_params = _agg_params(l1_k, device, l1_params)
    agg2 = AggregatorCircuit([layer2_target(l1_store, l1_params)])
    return _prove_aggregator(agg2, l2_store, l2_k, seed, transcript, device,
                             timer, keygen_timer, params, assignment)


def verify2_check(l2_store: FolderStore, l2_k: int = 22, device="cuda",
                  params: AccelParams | None = None):
    """Verify the layer-2 outer proof on values (the VerifyCheck analog)."""
    return verify_check_outer(l2_store, agg_k=l2_k, device=device,
                              params=params)
