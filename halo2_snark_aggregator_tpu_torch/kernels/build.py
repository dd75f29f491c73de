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
`sass_counts` reads the machine code (cuobjdump): the instructions of one
Montgomery product and of each kernel of the library;

    python -m halo2_snark_aggregator_tpu_torch.kernels.build --sass [CSRC [LIB]]

prints them as JSON (the product probe built against another source tree's
field.cuh, and the kernels of another built library, when given).
`imad_rates` measures the card's rate of the two multiply-adds a product
issues, 32-bit IMAD and IMAD.WIDE.U32, on chains of each alone:

    python -m halo2_snark_aggregator_tpu_torch.kernels.build --rates
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
           "msm_reduce", "curve_padd", "fixed_base", "ntt_transform")
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
    "h2t_fixed_base": [_P, _P, _P, _I64, _P],
    "h2t_ntt_pass": [_P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _P],
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


# One Montgomery product in isolation: the probe's instructions less those
# of a twin that XORs the same operands, plus the twin's 8 XORs.
_SASS_PROBE = r"""
#include "field.cuh"
namespace h2t {
__global__ void probe_mont_mul(const uint32_t* a, const uint32_t* b,
                               uint32_t* out) {
  const int i = threadIdx.x;
  fe_store(out + i * 8, mont_mul<kFq>(fe_load(a + i * 8), fe_load(b + i * 8)));
}
__global__ void probe_xor(const uint32_t* a, const uint32_t* b, uint32_t* out) {
  const int i = threadIdx.x;
  Fe x = fe_load(a + i * 8), y = fe_load(b + i * 8);
  for (int w = 0; w < 8; w++) x.w[w] ^= y.w[w];
  fe_store(out + i * 8, x);
}
}  // namespace h2t
"""
_SASS_FUNC = re.compile(r"Function : (\S+)")
_SASS_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")


def _tool(name: str) -> str:
    found = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not os.path.exists(found):
        raise RuntimeError(f"{name} not found")
    return found


def sass_opcodes(path: Path, full: bool = False) -> dict:
    """{kernel: {opcode: count}} of a cubin or shared library."""
    return parse_sass(subprocess.run(
        [_tool("cuobjdump"), "-sass", str(path)], capture_output=True,
        text=True, check=True).stdout, full)


def parse_sass(dump: str, full: bool = False) -> dict:
    """{kernel: {opcode: count}} from `cuobjdump -sass` text, NOPs left out;
    a kernel is named as in `ptxas_usage`, template instances summed. An
    opcode is its base name (IMAD for IMAD.WIDE.U32) unless `full`."""
    out: dict = {}
    cur = None
    for line in dump.splitlines():
        if m := _SASS_FUNC.search(line):
            n = re.match(r"_ZN3h2t(\d+)(\w+)", m.group(1))
            cur = out.setdefault(n.group(2)[: int(n.group(1))] if n
                                 else m.group(1), {})
        elif cur is not None and (m := _SASS_INSN.search(line)):
            op = m.group(1) if full else m.group(1).split(".")[0]
            if not op.startswith("NOP"):
                cur[op] = cur.get(op, 0) + 1
    return out


def sass_counts(csrc: Path = CSRC, lib: Path | None = None) -> dict:
    """{"mont_mul": instructions of one Montgomery product, "mont_mul_ops":
    its opcodes, "kernels": each kernel's instructions}. The product probe
    is built against `csrc`'s field.cuh; the kernels are those of the
    library `lib` (by default this tree's, built if need be)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / f"sass_probe{os.getpid()}.cu"
    cubin = src.with_suffix(".cubin")
    src.write_text(_SASS_PROBE)
    try:
        subprocess.run([_nvcc(), "-cubin", "-gencode",
                        "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-I", str(Path(csrc).resolve()), "-o", str(cubin),
                        str(src)], capture_output=True, text=True, check=True)
        probe = sass_opcodes(cubin)
    finally:
        src.unlink(missing_ok=True)
        cubin.unlink(missing_ok=True)
    mul, xor = probe["probe_mont_mul"], probe["probe_xor"]
    ops = {k: mul.get(k, 0) - xor.get(k, 0) for k in set(mul) | set(xor)}
    ops["LOP3"] = ops.get("LOP3", 0) + 8
    if lib is None:
        library()
        lib = Path(BUILD_INFO["path"])
    kernels = sass_opcodes(Path(lib))
    return {"mont_mul": sum(ops.values()),
            "mont_mul_ops": {k: v for k, v in sorted(ops.items()) if v},
            "kernels": {k: sum(v.values()) for k, v in sorted(kernels.items())}}


# The multiply-add rates: every thread runs 8 independent chains of one
# multiply-add, mad.lo.u32 (IMAD) or mad.wide.u32 (IMAD.WIDE.U32, the
# instruction ptxas makes of a product's mad.lo.cc / madc.hi.cc pair), 128
# a loop trip, 8 blocks of 256 threads an SM; timed by CUDA events. A
# reading counts only if the kernel's SASS holds the 128 (ptxas turned a
# chain with a fixed multiplicand into one multiply and 64-bit adds).
_RATE_PROBE = r"""
#include <cstdint>
#include <cuda_runtime.h>
namespace h2t {
template <bool kWide>
__device__ __forceinline__ void rate_probe(uint32_t* out, uint32_t m,
                                           int iters) {
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t x[8], y[8];
  uint64_t w[8];
#pragma unroll
  for (int j = 0; j < 8; j++) {
    x[j] = t * 8 + j;
    y[j] = t ^ j;
    w[j] = y[j];
  }
#pragma unroll 1
  for (int i = 0; i < iters; i++) {
#pragma unroll
    for (int u = 0; u < 16; u++) {
#pragma unroll
      for (int j = 0; j < 8; j++) {
        // each step's multiplicand is the last step's result, so no
        // compiler can fold the chain into fewer multiplies
        if (kWide)
          asm("{\n\t.reg .u32 lo, hi;\n\tmov.b64 {lo, hi}, %0;\n\t"
              "mad.wide.u32 %0, lo, %1, %0;\n\t}"
              : "+l"(w[j]) : "r"(m));
        else
          asm("mad.lo.u32 %0, %0, %1, %2;" : "+r"(y[j]) : "r"(m), "r"(x[j]));
      }
    }
  }
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < 8; j++)
    acc ^= kWide ? (uint32_t)w[j] ^ (uint32_t)(w[j] >> 32) : y[j];
  out[t] = acc;
}
__global__ void __launch_bounds__(256) rate_narrow(uint32_t* out, uint32_t m,
                                                   int iters) {
  rate_probe<false>(out, m, iters);
}
__global__ void __launch_bounds__(256) rate_wide(uint32_t* out, uint32_t m,
                                                 int iters) {
  rate_probe<true>(out, m, iters);
}
}  // namespace h2t

// ms of one launch (the mean of reps after a warm one) of 8 blocks an SM,
// and the SM count
extern "C" int h2t_rate_probe(int wide, int iters, int reps, float* ms,
                              int* sms) {
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks = *sms * 8;
  uint32_t* out = nullptr;
  cudaError_t err = cudaMalloc(&out, (size_t)blocks * 256 * sizeof(uint32_t));
  if (err != cudaSuccess) return (int)err;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  for (int r = 0; r <= reps; r++) {
    if (r == 1) cudaEventRecord(a);
    if (wide)
      h2t::rate_wide<<<blocks, 256>>>(out, 0x9e3779b9u, iters);
    else
      h2t::rate_narrow<<<blocks, 256>>>(out, 0x9e3779b9u, iters);
  }
  cudaEventRecord(b);
  err = cudaEventSynchronize(b);
  cudaEventElapsedTime(ms, a, b);
  *ms /= reps;
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  cudaFree(out);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
"""


def imad_rates(iters: int = 4096, reps: int = 5) -> dict:
    """The card's multiply-add rates: for IMAD and for IMAD.WIDE.U32, the
    instructions each probe kernel's loop issues (from its SASS), the ms of
    a launch, and the instructions a nanosecond an SM; `wide_over_narrow`
    is their ratio, which no clock enters."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / f"rate_probe{os.getpid()}.cu"
    so = src.with_suffix(".so")
    src.write_text(_RATE_PROBE)
    try:
        subprocess.run([_nvcc(), "-shared", "-Xcompiler", "-fPIC", "-gencode",
                        "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-o", str(so), str(src)], capture_output=True,
                       text=True, check=True)
        ops = sass_opcodes(so, full=True)
        probe = ctypes.CDLL(str(so))
        fn = probe.h2t_rate_probe
        fn.argtypes = [_I32, _I32, _I32, ctypes.POINTER(ctypes.c_float),
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        out = {}
        for wide, op, kern in ((0, "IMAD", "rate_narrow"),
                               (1, "IMAD.WIDE.U32", "rate_wide")):
            ms, sms = ctypes.c_float(0), ctypes.c_int(0)
            check(fn(wide, iters, reps, ctypes.byref(ms), ctypes.byref(sms)),
                  "rate_probe")
            # the loop issues 128 of the op a trip, the set-up and the sink
            # a few more
            issued = sms.value * 8 * 256 * iters * 128
            in_kernel = ops[kern].get(op, 0)
            if in_kernel < 128:
                raise RuntimeError(f"{kern} holds {in_kernel} {op}, not the "
                                   f"loop's 128: {ops[kern]}")
            out[op] = dict(ms=ms.value, in_kernel=in_kernel,
                           per_ns_per_sm=issued / (ms.value * 1e6) / sms.value)
    finally:
        src.unlink(missing_ok=True)
        so.unlink(missing_ok=True)
    out["sms"] = sms.value
    out["wide_over_narrow"] = (out["IMAD.WIDE.U32"]["per_ns_per_sm"]
                               / out["IMAD"]["per_ns_per_sm"])
    return out


def check(rc: int, what: str) -> None:
    """Raise if a C launcher returned a nonzero cudaGetLastError()."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rates"]:
        print(json.dumps(imad_rates()))
        sys.exit(0)
    if sys.argv[1:2] == ["--sass"]:
        print(json.dumps(sass_counts(*map(Path, sys.argv[2:4]))))
        sys.exit(0)
    if len(sys.argv) > 1:
        text = Path(sys.argv[1]).read_text()
    else:
        library()
        text = Path(BUILD_INFO["ptxas_log"]).read_text()
    print(json.dumps(ptxas_usage(text)))
