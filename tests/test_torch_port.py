"""Port-wide contracts: no jax anywhere in the port, CUDA requested means
CUDA or an error, the kernel build raises instead of falling back, and the
SRS cache writes atomically."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from halo2_snark_aggregator_tpu_torch import device as dv
from halo2_snark_aggregator_tpu_torch import fixtures
from halo2_snark_aggregator_tpu_torch.kernels import build
from halo2_snark_aggregator_tpu_torch.prover import srs

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "halo2_snark_aggregator_tpu_torch"


def _port_modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_no_jax():
    """Importing every module of the port loads neither jax nor any module
    of the JAX package."""
    mods = _port_modules()
    assert "halo2_snark_aggregator_tpu_torch.protocol.batched" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m.split('.')[0] == 'halo2_snark_aggregator_tpu')\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_cuda_request_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        dv.cuda_device()
    with pytest.raises(RuntimeError):
        dv.resolve("cuda")
    assert dv.resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        dv.resolve("meta")


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda _name: None)
    monkeypatch.setattr(os.path, "exists", lambda _p: False)
    monkeypatch.setattr(build, "BUILD_DIR", Path("/nonexistent-build-dir"))
    build.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            build.library()
    finally:
        build.library.cache_clear()


def test_build_digest_covers_every_source():
    names = {p.name for p in build._sources()}
    assert {"field.cu", "field.cuh", "poseidon.cu", "msm.cu", "curve.cu",
            "curve.cuh", "ntt.cu"} <= names
    assert len(build.source_digest()) == 16
    assert set(build.LAUNCHES) == set(build.KERNELS)


def test_parse_sass_counts_each_kernel():
    """Opcodes per kernel from cuobjdump -sass text: predicated
    instructions count, NOPs do not, template instances add up; with
    `full`, an opcode keeps its modifiers."""
    dump = """
\t\tFunction : _ZN3h2t11padd_kernelEPKjS1_Pjl
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
        /*0010*/                   IMAD.WIDE.U32 R2, R0, 0x20, R2 ;
        /*0020*/               @!P0 IADD3.X R5, R4, R4, RZ, P0, !PT ;
        /*0030*/                   IMAD.HI.U32 R6, R7, R8, RZ ;
        /*0040*/                   NOP ;
\t\tFunction : _ZN3h2t12field_kernelILi0EEEviPKj
        /*0000*/                   IADD3 R1, R2, R3, RZ ;
\t\tFunction : _ZN3h2t12field_kernelILi1EEEviPKj
        /*0000*/                   IADD3 R1, R2, R3, RZ ;
        /*0010*/                   EXIT ;
"""
    assert build.parse_sass(dump) == {
        "padd_kernel": {"LDC": 1, "IMAD": 2, "IADD3": 1},
        "field_kernel": {"IADD3": 2, "EXIT": 1}}
    assert build.parse_sass(dump, full=True)["padd_kernel"] == {
        "LDC": 1, "IMAD.WIDE.U32": 1, "IADD3.X": 1, "IMAD.HI.U32": 1}


def test_ptxas_usage_reads_each_kernel():
    """Registers, stack and spills per kernel from an nvcc -Xptxas -v log:
    template instances keep the largest figures, and a called function's
    stack frame is not its caller's."""
    log = """== msm.cu
ptxas info    : Compiling entry function '_ZN3h2t13reduce_kernelEPKjliPj' for 'sm_90a'
ptxas info    : Function properties for _ZN3h2t13reduce_kernelEPKjliPj
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 250 registers, used 1 barriers, 24576 bytes smem
ptxas info    : Function properties for _ZN3h2t8full_addERKNS_2PtES2_
    96 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
== field.cu
ptxas info    : Compiling entry function '_ZN3h2t12field_kernelILi0EEEviPKj' for 'sm_90a'
ptxas info    : Function properties for _ZN3h2t12field_kernelILi0EEEviPKj
    40 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 46 registers
ptxas info    : Compiling entry function '_ZN3h2t12field_kernelILi1EEEviPKj' for 'sm_90a'
ptxas info    : Function properties for _ZN3h2t12field_kernelILi1EEEviPKj
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 52 registers
"""
    assert build.ptxas_usage(log) == {
        "reduce_kernel": dict(registers=250, stack=8, spill_stores=4,
                              spill_loads=12),
        "field_kernel": dict(registers=52, stack=40, spill_stores=0,
                             spill_loads=0)}


def test_chip_smoke_fails_without_cuda(tmp_path):
    """No card: exit nonzero and print no result, in the repo and in a
    directory that holds chip_smoke.py alone."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd in (REPO, tmp_path):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_cache_writes_atomically(tmp_path, monkeypatch):
    """The SRS cache is made once, moved into place whole, and read back."""
    calls = []
    make = srs.unsafe_setup_accel

    def counted(*args, **kwargs):
        calls.append(1)
        return make(*args, **kwargs)

    monkeypatch.setattr(srs, "unsafe_setup_accel", counted)
    cache = tmp_path / "sub"
    first = srs.setup_cached_accel(2, cache_dir=cache, device="cpu")
    again = srs.setup_cached_accel(2, cache_dir=cache, device="cpu")
    assert calls == [1]
    assert [p.name for p in cache.iterdir()] == ["accel_params_k2.npz"]
    assert torch.equal(first.g_dev, again.g_dev)
    assert first.g_lagrange == again.g_lagrange


def test_k16_fixture_files():
    wl = fixtures.workload(16)
    proofs = fixtures.load_proofs(16, wl.fingerprint, 4)
    assert len(proofs) == 4
    assert len({len(p) for p, _ in proofs}) == 1
    with open(fixtures.FIXTURE_DIR /
              f"zkevm_proof_k16_{wl.fingerprint}_0.json") as f:
        assert bytes.fromhex(json.load(f)["proof"]) == proofs[0][0]


def test_fixture_workloads():
    """Each workload names its committed proofs; K=18's key is the
    131-column circuit (43 groups), its one proof for one instance column."""
    assert sorted(fixtures.WORKLOADS) == [16, 18]
    for k, wl in fixtures.WORKLOADS.items():
        assert wl.k == k
        proofs = wl.load_proofs()
        assert len(proofs) == wl.proofs
        for p, inst in proofs:
            assert len(inst) == 1 and len(p) > 0
        c = wl.circuit(2)
        assert (c.K, c.seed, c.n_groups) == (k, 2, wl.n_groups)
    assert fixtures.workload(18).n_groups == 43
    with pytest.raises(ValueError, match="no fixture workload"):
        fixtures.workload(17)
