# Copy of halo2_snark_aggregator_tpu/native/__init__.py, so that the port
# imports nothing of the JAX package. It compiles the port's own copy of
# the C++ source into the port's gitignored _build/. Edits, each a line
# of the reference (edit-) and its replacement (edit+);
# tests/test_torch_host_copies.py applies them to the reference and holds
# the result equal to this file:
# edit- _SRC = os.path.join(_REPO_ROOT, "native", "bn254_native.cpp")
# edit+ _SRC = os.path.join(_REPO_ROOT, "halo2_snark_aggregator_tpu_torch", "csrc", "bn254_native.cpp")
# edit-     build_dir = os.path.join(_REPO_ROOT, "native", "build")
# edit+     build_dir = os.path.join(_REPO_ROOT, "halo2_snark_aggregator_tpu_torch", "_build")
"""ctypes bridge to the native host runtime (native/bn254_native.cpp).

The C++ library is the compiled companion of the host-exact oracle layer —
the role halo2curves (compiled Rust) plays for the reference. It accelerates
the host side of the hybrid verify path (Poseidon transcript replay, SRS /
commitment MSMs, prover NTTs) while the Python-int implementations remain the
differential oracle (tests/test_native.py).

Compiled lazily with g++ on first use; everything degrades gracefully to the
pure-Python path when a toolchain is unavailable (`available()` -> False).
Disable explicitly with H2T_NO_NATIVE=1.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "halo2_snark_aggregator_tpu_torch", "csrc", "bn254_native.cpp")

_lib = None
_lib_lock = threading.Lock()
_load_failed = False
_poseidon_ready = False

FR = 0
FQ = 1


def _build_and_load():
    """Compile (cached by source hash) and dlopen the native library."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    build_dir = os.path.join(_REPO_ROOT, "halo2_snark_aggregator_tpu_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    so_path = os.path.join(build_dir, f"libbn254native-{digest}.so")
    if not os.path.exists(so_path):
        tmp = so_path + f".tmp{os.getpid()}"
        base = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-o", tmp, _SRC]
        try:
            subprocess.run(base[:1] + ["-march=native"] + base[1:],
                           check=True, capture_output=True)
        except subprocess.CalledProcessError:
            subprocess.run(base, check=True, capture_output=True)
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.h2t_init.argtypes = []
    lib.h2t_fe_op.argtypes = [ctypes.c_int, ctypes.c_int, c_u8p, c_u8p, c_u8p, ctypes.c_size_t]
    lib.h2t_fe_pow.argtypes = [ctypes.c_int, c_u8p, c_u8p, c_u8p, ctypes.c_size_t]
    lib.h2t_fe_inv_batch.argtypes = [ctypes.c_int, c_u8p, c_u8p, ctypes.c_size_t]
    lib.h2t_poseidon_setup.argtypes = [c_u8p, ctypes.c_size_t, c_u8p,
                                       ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.h2t_poseidon_permute.argtypes = [c_u8p, ctypes.c_size_t]
    lib.h2t_g1_mul_batch.argtypes = [c_u8p, c_u8p, c_u8p, c_u8p, ctypes.c_size_t,
                                     c_u8p, c_u8p, c_u8p]
    lib.h2t_g1_msm.argtypes = [c_u8p, c_u8p, c_u8p, c_u8p, ctypes.c_size_t, c_u8p, c_u8p]
    lib.h2t_fr_ntt.argtypes = [c_u8p, ctypes.c_size_t, c_u8p]
    lib.h2t_pairing_check.argtypes = [c_u8p, c_u8p, c_u8p, c_u8p, ctypes.c_size_t,
                                      c_u8p, ctypes.c_size_t]
    lib.h2t_pairing_check.restype = ctypes.c_int
    lib.h2t_init()
    return lib


def _get():
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed or os.environ.get("H2T_NO_NATIVE"):
        return None
    with _lib_lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            _lib = _build_and_load()
        except Exception:
            _load_failed = True
            return None
    return _lib


def available() -> bool:
    return _get() is not None


# -- byte packing -------------------------------------------------------------

def _buf(data: bytes):
    return ctypes.cast(ctypes.create_string_buffer(data, len(data)),
                       ctypes.POINTER(ctypes.c_uint8))


def _outbuf(nbytes: int):
    b = ctypes.create_string_buffer(nbytes)
    return b, ctypes.cast(b, ctypes.POINTER(ctypes.c_uint8))


def _pack(vals) -> bytes:
    return b"".join(int(v).to_bytes(32, "little") for v in vals)


def _unpack(raw: bytes, n: int):
    return [int.from_bytes(raw[32 * i : 32 * i + 32], "little") for i in range(n)]


# -- field ops ----------------------------------------------------------------

def fe_op(field: int, op: int, a, b):
    """Elementwise op over canonical ints. op: 0=add 1=sub 2=mul."""
    lib = _get()
    n = len(a)
    out, outp = _outbuf(32 * n)
    lib.h2t_fe_op(field, op, _buf(_pack(a)), _buf(_pack(b)), outp, n)
    return _unpack(out.raw, n)


def fe_mul(field: int, a, b):
    return fe_op(field, 2, a, b)


def fe_pow(field: int, a, e: int):
    lib = _get()
    n = len(a)
    out, outp = _outbuf(32 * n)
    lib.h2t_fe_pow(field, _buf(_pack(a)), _buf(_pack([e])), outp, n)
    return _unpack(out.raw, n)


def fe_inv_batch(field: int, a):
    lib = _get()
    n = len(a)
    out, outp = _outbuf(32 * n)
    lib.h2t_fe_inv_batch(field, _buf(_pack(a)), outp, n)
    return _unpack(out.raw, n)


# -- poseidon -----------------------------------------------------------------

def _ensure_poseidon(lib):
    global _poseidon_ready
    if _poseidon_ready:
        return
    from ..hashes import poseidon_spec as spec

    rc, mds = spec.generate_constants()
    flat_rc = [c for row in rc for c in row]
    flat_mds = [c for row in mds for c in row]
    lib.h2t_poseidon_setup(_buf(_pack(flat_rc)), len(rc), _buf(_pack(flat_mds)),
                           spec.T, spec.R_F, spec.R_P)
    _poseidon_ready = True


def poseidon_permute(state):
    """One permutation of the default (T=9, 8/63) BN254-Fr Poseidon."""
    lib = _get()
    _ensure_poseidon(lib)
    buf = ctypes.create_string_buffer(_pack(state), 32 * len(state))
    lib.h2t_poseidon_permute(ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8)), 1)
    return _unpack(buf.raw, len(state))


# -- G1 -----------------------------------------------------------------------

def _pack_points(points):
    xs, ys, inf = [], [], bytearray()
    for p in points:
        if p is None:
            xs.append(0)
            ys.append(0)
            inf.append(1)
        else:
            xs.append(p[0])
            ys.append(p[1])
            inf.append(0)
    return _pack(xs), _pack(ys), bytes(inf)


def g1_msm(points, scalars):
    lib = _get()
    n = len(points)
    xs, ys, inf = _pack_points(points)
    out, outp = _outbuf(64)
    oinf, oinfp = _outbuf(1)
    lib.h2t_g1_msm(_buf(xs), _buf(ys), _buf(inf), _buf(_pack(scalars)), n, outp, oinfp)
    if oinf.raw[0]:
        return None
    return (int.from_bytes(out.raw[:32], "little"), int.from_bytes(out.raw[32:], "little"))


def g1_mul_batch(points, scalars):
    lib = _get()
    n = len(points)
    xs, ys, inf = _pack_points(points)
    oxs, oxsp = _outbuf(32 * n)
    oys, oysp = _outbuf(32 * n)
    oinf, oinfp = _outbuf(n)
    lib.h2t_g1_mul_batch(_buf(xs), _buf(ys), _buf(inf), _buf(_pack(scalars)), n,
                         oxsp, oysp, oinfp)
    out = []
    for i in range(n):
        if oinf.raw[i]:
            out.append(None)
        else:
            out.append((int.from_bytes(oxs.raw[32 * i : 32 * i + 32], "little"),
                        int.from_bytes(oys.raw[32 * i : 32 * i + 32], "little")))
    return out


# -- pairing ------------------------------------------------------------------

_hard_exp_bytes = None


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 (shared final exponentiation).

    P_i: affine G1 tuple | None; Q_i: affine G2 (Fq2, Fq2) tuple | None.
    """
    global _hard_exp_bytes
    lib = _get()
    from ..ff.bn254 import P as FQ_MOD, R as FR_MOD

    if _hard_exp_bytes is None:
        hard = (FQ_MOD**4 - FQ_MOD**2 + 1) // FR_MOD
        _hard_exp_bytes = hard.to_bytes((hard.bit_length() + 7) // 8, "little")
    g1xy, g1inf, g2c, g2inf = bytearray(), bytearray(), bytearray(), bytearray()
    for p, q in pairs:
        if p is None or q is None:
            g1xy += b"\x00" * 64
            g2c += b"\x00" * 128
            g1inf.append(1)
            g2inf.append(1)
            continue
        g1xy += int(p[0]).to_bytes(32, "little") + int(p[1]).to_bytes(32, "little")
        qx, qy = q
        g2c += (int(qx.c0).to_bytes(32, "little") + int(qx.c1).to_bytes(32, "little")
                + int(qy.c0).to_bytes(32, "little") + int(qy.c1).to_bytes(32, "little"))
        g1inf.append(0)
        g2inf.append(0)
    return bool(lib.h2t_pairing_check(
        _buf(bytes(g1xy)), _buf(bytes(g1inf)), _buf(bytes(g2c)), _buf(bytes(g2inf)),
        len(pairs), _buf(_hard_exp_bytes), len(_hard_exp_bytes)))


# -- NTT ----------------------------------------------------------------------

def fr_ntt(values, omega: int):
    lib = _get()
    n = len(values)
    buf = ctypes.create_string_buffer(_pack(values), 32 * n)
    lib.h2t_fr_ntt(ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8)), n,
                   _buf(_pack([omega])))
    return _unpack(buf.raw, n)
