"""The program under test, as the entries drive it: the port's public entry
points only (the SRS cache, keygen, `VerifyingKey`, `BatchedVerifier`,
`create_proof_accel` and its `StageTimer`), and the card's description.

The port builds its kernels into its own `_build/` and caches the SRS in
its own `_cache/`, both inside the checkout at fixed paths. A verify cell
is given its key as a verifier deployment is: the port's constraint system
of the circuit with the committed commitments (`reference/keys/`, a raw
file the reference reads too), checked against the configuration's
fingerprint by the port's own check. No verify run makes a key.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FIXTURES = HERE / "fixtures"
KEYS = HERE / "reference" / "keys"


def fixture_lines(cfg: dict) -> list[dict]:
    """The configuration's committed proofs, one dict a proof: `proof`
    (hex), `instances`, and the `witness_seed` and `blinding_seed` it was
    made with."""
    with open(FIXTURES / cfg["proofs"]) as f:
        return [json.loads(line) for line in f if line.strip()]


def fixture_proofs(cfg: dict) -> list:
    """[(proof bytes, instances)] of the configuration's committed proofs."""
    return [(bytes.fromhex(d["proof"]),
             [[int(v) for v in col] for col in d["instances"]])
            for d in fixture_lines(cfg)]


def cuda():
    import torch

    return torch.device("cuda", 0)


def synchronize() -> None:
    import torch

    torch.cuda.synchronize()


def srs(k: int, dev):
    """The port's SRS of size 2^k (from its `_cache/` after the first run)."""
    from halo2_snark_aggregator_tpu_torch.prover import srs as srs_mod

    return srs_mod.setup_cached_accel(k, device=dev)


def circuit(cfg: dict, seed: int):
    from halo2_snark_aggregator_tpu_torch.circuits.zkevm import ZkevmShapeCircuit

    return ZkevmShapeCircuit(k=cfg["k"], seed=seed, n_groups=cfg["n_groups"])


def keygen(cfg: dict, params):
    """(vk, proving key) by the port's keygen on the card; raises unless the
    key is the configuration's."""
    from halo2_snark_aggregator_tpu_torch import fixtures
    from halo2_snark_aggregator_tpu_torch.prover import accel

    params.commit_mode = "device"
    vk, apk = accel.keygen_accel(circuit(cfg, 1), cfg["k"], params)
    fixtures.check_fingerprint(vk, cfg["fingerprint"])
    return vk, apk


def verifier_key(cfg: dict):
    """The configuration's vk: the port's constraint system of the circuit
    and the committed commitments; raises unless its fingerprint is the
    configuration's."""
    from halo2_snark_aggregator_tpu_torch import fixtures
    from halo2_snark_aggregator_tpu_torch.protocol.plonk import (
        ConstraintSystem, VerifyingKey)

    cs = ConstraintSystem()
    circuit(cfg, 1).configure(cs)
    with open(KEYS / f"{cfg['fingerprint']}.json") as f:
        data = json.load(f)

    def pts(ps):
        return [None if p is None else (int(p[0]), int(p[1])) for p in ps]

    vk = VerifyingKey(k=cfg["k"], cs=cs, fixed_commitments=pts(data["fixed"]),
                      permutation_commitments=pts(data["permutation"]))
    fixtures.check_fingerprint(vk, cfg["fingerprint"])
    return vk


class Verifier:
    """`BatchedVerifier` over the configuration's committed proofs: a call
    takes the lanes' proof indices."""

    def __init__(self, cfg: dict, proofs: list, batch: int):
        from halo2_snark_aggregator_tpu_torch.protocol.batched import BatchedVerifier

        dev = cuda()
        vk = verifier_key(cfg)
        params = srs(cfg["k"], dev)
        self.proofs = proofs
        self.bv = BatchedVerifier(vk, params, batch=batch,
                                  sample_proof=proofs[0][0],
                                  sample_instances=proofs[0][1], device=dev)

    def verify(self, lanes: list):
        return self.bv.verify([self.proofs[i][0] for i in lanes],
                              [self.proofs[i][1] for i in lanes])

    @property
    def last_profile(self) -> dict:
        return dict(self.bv.last_profile)

    def close(self) -> None:
        self.bv = None


def span_timer(enabled: bool):
    """The port's `StageTimer` (exclusive seconds a span, a synchronize at
    each boundary when enabled), also keeping each span's wall-clock
    interval for naming the trace's idle gaps."""
    from halo2_snark_aggregator_tpu_torch.prover.accel import StageTimer

    class SpanTimer(StageTimer):
        def __init__(self):
            super().__init__(cuda(), enabled)
            self.intervals: list = []

        @contextlib.contextmanager
        def span(self, name: str):
            if not self.enabled:
                yield
                return
            t0 = time.time_ns()
            with super().span(name):
                yield
            self.intervals.append((name, t0, time.time_ns()))

    return SpanTimer()


class Prover:
    """`create_proof_accel` on the configuration's proving key: a call
    proves the circuit of one witness seed with one blinding seed.

    While `scalars` is a list, every commitment's Montgomery scalars (the
    tensor the prover hands `commit_coeff_mont`, kept, not copied) are
    appended to it, for the roofline's count of the accumulate's work."""

    def __init__(self, cfg: dict):
        dev = cuda()
        self.cfg = cfg
        self.params = srs(cfg["k"], dev)
        self.vk, self.apk = keygen(cfg, self.params)
        self.timer = span_timer(False)
        self.scalars: list | None = None
        commit = self.params.commit_coeff_mont

        def kept(coeffs_mont):
            if self.scalars is not None:
                self.scalars.append(coeffs_mont)
            return commit(coeffs_mont)

        self.params.commit_coeff_mont = kept

    def prove(self, seeds: tuple) -> bytes:
        from halo2_snark_aggregator_tpu_torch.prover import accel
        from halo2_snark_aggregator_tpu_torch.transcript.host import PoseidonWrite

        witness_seed, blinding_seed = seeds
        c = circuit(self.cfg, witness_seed)
        proof = accel.create_proof_accel(self.apk, self.params, [c],
                                         [c.instances()], PoseidonWrite(),
                                         seed=blinding_seed, timer=self.timer)
        synchronize()
        return proof

    def close(self) -> None:
        self.apk = self.params = None


def card() -> dict:
    """The card's name, and its power limit as nvidia-smi reads it."""
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30,
                             check=True)
        info["power_limit_w"] = float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        info["power_limit_w"] = None
    return info


def peak_bytes() -> int:
    import torch

    return int(torch.cuda.max_memory_allocated())


def free() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
