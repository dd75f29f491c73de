"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` source compiles with its own nvcc for `sm_90a`, all
started together, and the objects link into one shared library with a
plain C interface, keyed by a hash of every source and header, under
`_build/` (gitignored). It is loaded with `ctypes`, with `argtypes` set for
every entry point. The build runs at first use; a missing nvcc or a failed
compile raises — there is no fallback.

Every kernel wrapper adds one to its entry in `LAUNCHES` where it launches
its kernel, so a run can show that the main path went through the kernels.

Each build keeps nvcc's `-Xptxas -v` report beside the library;
`ptxas_usage` reads each kernel's registers and spill bytes from it:

    python -m halo2_snark_aggregator_tpu_torch.kernels.build [PTXAS_LOG]

prints them as JSON (for the given log, or after building the library).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

KERNELS = ("field", "field_program", "poseidon", "msm_accumulate",
           "msm_reduce", "curve_padd", "ntt_transform", "ntt_scale")
LAUNCHES = dict.fromkeys(KERNELS, 0)
BUILD_INFO: dict = {}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_SIGNATURES = {
    "h2t_field": [_I32, _I32, _P, _P, _P, _P, _I32, _P, _P, _I64, _I64, _P,
                  _I32, _P],
    "h2t_field_program": [_P, _I32, _P, _I32, _P, _I32, _P, _I32, _P, _I64,
                          _P],
    "h2t_poseidon_chain": [_P, _I64, _I32, _P, _P, _P, _P, _P, _P, _P, _P],
    "h2t_msm_accumulate": [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _P, _P],
    "h2t_msm_reduce": [_P, _I64, _I64, _I32, _I32, _P, _P],
    "h2t_curve_padd": [_P, _P, _P, _I64, _P],
    "h2t_ntt_pass": [_P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _P],
    "h2t_ntt_scale": [_P, _P, _P, _I64, _P],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_launch(kernel: str) -> None:
    LAUNCHES[kernel] += 1


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_digest() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fixed = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fixed):
        return fixed
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def _compile(so_path: Path) -> None:
    """One nvcc per source, all running at once, then one link."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so_path.stem}.tmp{os.getpid()}"
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}-{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj),
               str(src)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs, failed = [], []
    for src, _obj, proc in jobs:
        out, err = proc.communicate()
        logs.append(f"== {src.name}\n{err}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{out}\n{err}")
    objs = [obj for _src, obj, _proc in jobs]
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = so_path.with_suffix(f".tmp{os.getpid()}.so")
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    _ptxas_log(so_path).write_text("\n".join(logs))
    os.replace(tmp, so_path)


def _ptxas_log(so_path: Path) -> Path:
    return BUILD_DIR / f"ptxas-{so_path.stem}.log"


_ENTRY = re.compile(r"Compiling entry function '(_ZN3h2t(\d+)(\w+))'")
_PROPS = re.compile(r"Function properties for (\S+)")
_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_usage(log: str) -> dict:
    """{kernel: {"registers", "stack", "spill_stores", "spill_loads"}} from
    a `-Xptxas -v` log. A kernel is named by its identifier in namespace
    h2t; template instances of one kernel keep the largest figures."""
    usage: dict = {}
    name = entry = props = None
    for line in log.splitlines():
        fields = ()
        if m := _ENTRY.search(line):
            entry, name = m.group(1), m.group(3)[: int(m.group(2))]
            usage.setdefault(name, dict.fromkeys(
                ("registers", "stack", "spill_stores", "spill_loads"), 0))
        elif m := _PROPS.search(line):
            props = m.group(1)
        elif (m := _STACK.search(line)) and entry and props == entry:
            # the properties of the entry itself, not of a called function
            fields = zip(("stack", "spill_stores", "spill_loads"), m.groups())
        elif (m := _REGS.search(line)) and name:
            fields = [("registers", m.group(1))]
        for key, val in fields:
            usage[name][key] = max(usage[name][key], int(val))
    return usage


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    so_path = BUILD_DIR / f"libh2t_kernels-{source_digest()}.so"
    t0 = time.perf_counter()
    built = not so_path.exists()
    if built:
        _compile(so_path)
    lib = ctypes.CDLL(str(so_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    BUILD_INFO.update(path=str(so_path), built=built,
                      seconds=time.perf_counter() - t0,
                      ptxas_log=str(_ptxas_log(so_path)))
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C launcher returned a nonzero cudaGetLastError()."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


if __name__ == "__main__":
    if len(sys.argv) > 1:
        text = Path(sys.argv[1]).read_text()
    else:
        library()
        text = Path(BUILD_INFO["ptxas_log"]).read_text()
    print(json.dumps(ptxas_usage(text)))
