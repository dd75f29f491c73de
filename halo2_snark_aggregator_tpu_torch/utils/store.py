# Copy of halo2_snark_aggregator_tpu/utils/store.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""File store: persistent pipeline artifacts (reference fs.rs equivalent).

Every pipeline stage reads/writes named artifacts under a folder, making
stages independently re-runnable — the reference's checkpoint/resume story
(SURVEY §5: "The file store *is* the checkpoint system"; fs.rs:21-203).
File names mirror the reference scheme: sample_circuit_<name>.params,
verify_circuit.{params,vkey}, verify_circuit_{instance,proof,final_pair}.data.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path

from ..ff import bn254 as ff


class FolderStore:
    def __init__(self, folder: str | Path):
        self.folder = Path(folder)
        self.folder.mkdir(parents=True, exist_ok=True)

    # -- generic -----------------------------------------------------------
    def _path(self, name: str) -> Path:
        return self.folder / name

    def write_bytes(self, name: str, data: bytes):
        self._path(name).write_bytes(data)

    def read_bytes(self, name: str) -> bytes:
        return self._path(name).read_bytes()

    def write_obj(self, name: str, obj):
        with open(self._path(name), "wb") as f:
            pickle.dump(obj, f)

    def read_obj(self, name: str):
        with open(self._path(name), "rb") as f:
            return pickle.load(f)

    def exists(self, name: str) -> bool:
        return self._path(name).exists()

    # -- target-circuit artifacts (fs.rs:39-105) ---------------------------
    def write_target_params(self, name: str, params):
        self.write_obj(f"sample_circuit_{name}.params", params)

    def read_target_params(self, name: str):
        return self.read_obj(f"sample_circuit_{name}.params")

    def write_target_vkey(self, name: str, vk):
        self.write_obj(f"sample_circuit_{name}.vkey", vk)

    def read_target_vkey(self, name: str):
        return self.read_obj(f"sample_circuit_{name}.vkey")

    def write_target_proof(self, name: str, index: int, proof: bytes):
        self.write_bytes(f"sample_circuit_proof_{name}{index}.data", proof)

    def read_target_proof(self, name: str, index: int) -> bytes:
        return self.read_bytes(f"sample_circuit_proof_{name}{index}.data")

    def write_target_instance(self, name: str, index: int, instances):
        self.write_obj(f"sample_circuit_instance_{name}{index}.data", instances)

    def read_target_instance(self, name: str, index: int):
        return self.read_obj(f"sample_circuit_instance_{name}{index}.data")

    # -- verify-circuit artifacts (fs.rs:107-203) --------------------------
    def write_verify_params(self, params):
        self.write_obj("verify_circuit.params", params)

    def read_verify_params(self):
        return self.read_obj("verify_circuit.params")

    def write_verify_vkey(self, vk):
        self.write_obj("verify_circuit.vkey", vk)

    def read_verify_vkey(self):
        return self.read_obj("verify_circuit.vkey")

    def write_verify_instance(self, instances):
        self.write_obj("verify_circuit_instance.data", instances)

    def read_verify_instance(self):
        return self.read_obj("verify_circuit_instance.data")

    def write_verify_proof(self, proof: bytes):
        self.write_bytes("verify_circuit_proof.data", proof)

    def read_verify_proof(self) -> bytes:
        return self.read_bytes("verify_circuit_proof.data")

    def write_final_pair(self, w_x, w_g):
        self.write_obj("verify_circuit_final_pair.data", (w_x, w_g))

    def read_final_pair(self):
        return self.read_obj("verify_circuit_final_pair.data")

    def write_solidity(self, source: str, name: str = "verifier.sol"):
        self._path(name).write_text(source)
