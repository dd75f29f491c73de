"""The port's CUDA device code run on the CPU: csrc/field.cuh (the Montgomery
product, the modular add and subtract, the Poseidon MDS row sum and REDC,
all on PTX carry chains), csrc/curve.cuh (the complete and mixed adds) and
csrc/curve.cu's fixed-base kernel, compiled with g++
against tests/cuda_emu/: host stand-ins for the CUDA names, the carry-chain
instructions emulated with one carry flag a thread (a read of an undefined
flag or of the other kind's, an add reading a subtract's flag or the
reverse, or a carry out of a chain end that the header declares
carry-free, fails),
and the kernel run one thread at a time. Held against Python
integers and the reference's host curve (`ff/bn254`), and word for word
against the port's plain twins. Exact equality. No card and no nvcc: the
sources themselves run."""

import functools
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from halo2_snark_aggregator_tpu.ff import bn254 as ff
from halo2_snark_aggregator_tpu_torch.kernels import build
from halo2_snark_aggregator_tpu_torch.ops import curve as cv
from halo2_snark_aggregator_tpu_torch.ops import field as fo
from halo2_snark_aggregator_tpu_torch.prover import srs

EMU = Path(__file__).resolve().parent / "cuda_emu"
MODULI = {"Fr": (0, ff.R), "Fq": (1, ff.P)}
R256 = 1 << 256


@functools.lru_cache(maxsize=1)
def _harness() -> str:
    """Build the harness once a process: field.cuh with its `namespace ptx`
    block replaced by the emulation, curve.cuh as it is, and curve.cu's
    device code (everything before its host launchers)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the CPU")
    tmp = Path(tempfile.mkdtemp(prefix="h2t_csrc_emu"))
    field = (build.CSRC / "field.cuh").read_text()
    a = field.index("namespace ptx {")
    end = "}  // namespace ptx"
    b = field.index(end) + len(end)
    (tmp / "field.cuh").write_text(field[:a] + '#include "ptx_emu.h"' + field[b:])
    shutil.copy(build.CSRC / "curve.cuh", tmp / "curve.cuh")
    curve = (build.CSRC / "curve.cu").read_text()
    end = "}  // namespace h2t"
    (tmp / "curve_kernels.h").write_text(
        curve[: curve.index(end) + len(end)] + "\n")
    exe = tmp / "harness"
    subprocess.run([gxx, "-std=c++20", "-O1", "-I", str(tmp),
                    "-I", str(EMU), "-o", str(exe), str(EMU / "harness.cpp")],
                   check=True, capture_output=True, text=True)
    return str(exe)


def _run(lines: list[str]) -> list[str]:
    out = subprocess.run([_harness()], input="\n".join(lines) + "\n",
                         capture_output=True, text=True, check=True).stdout
    out = out.splitlines()
    assert len(out) == len(lines)
    errors = [o for o in out if o.startswith("ERROR")]
    assert not errors, errors[:3]
    return out


def _hex(v: int) -> str:
    return " ".join(f"{(v >> (32 * i)) & 0xFFFFFFFF:08x}" for i in range(8))


def _int(words: list[str]) -> int:
    return sum(int(w, 16) << (32 * i) for i, w in enumerate(words))


def _tensor_hex(t: torch.Tensor) -> str:
    return " ".join(f"{v & 0xFFFFFFFF:08x}" for v in t.reshape(-1).tolist())


@functools.lru_cache(maxsize=1)
def _table() -> tuple[torch.Tensor, str]:
    table = srs.g1_table("cpu")
    return table, _tensor_hex(table)


def _words_tensor(line: str) -> torch.Tensor:
    return torch.tensor([int(w, 16) for w in line.split()],
                        dtype=torch.int64).to(torch.int32)


@pytest.mark.parametrize("field", ["Fr", "Fq"])
def test_emulated_field_ops_match_ints(field):
    """mont_mul on canonical b and any a < 2^256 (the field kernel's
    std -> Montgomery feeds unreduced operands); mod_add and mod_sub on
    canonical operands; the MDS row sum of 9 products and its REDC."""
    f, p = MODULI[field]
    rinv = pow(R256, -1, p)
    rng = np.random.default_rng(30 + f)

    def rand(bound):
        return int.from_bytes(rng.bytes(32), "little") % bound

    cases, want = [], []
    special_a = [0, 1, p - 1, p, p + 1, 2 * p, R256 - 1, R256 - p, 1 << 255]
    special_b = [0, 1, 2, p - 1, p - 2, (p - 1) // 2]
    pairs = [(x, y) for x in special_a for y in special_b]
    pairs += [(rand(R256), rand(p)) for _ in range(400)]
    pairs += [(rand(p), rand(p)) for _ in range(400)]
    for x, y in pairs:
        cases.append(f"mul {f} {_hex(x)} {_hex(y)}")
        want.append(x * y * rinv % p)
    pairs = [(x, y) for x in (0, 1, p - 1) for y in (0, 1, p - 1)]
    pairs += [(rand(p), rand(p)) for _ in range(300)]
    for x, y in pairs:
        cases += [f"add {f} {_hex(x)} {_hex(y)}", f"sub {f} {_hex(x)} {_hex(y)}"]
        want += [(x + y) % p, (x - y) % p]
    for t in range(40):
        prods = ([(p - 1, p - 1)] * 9 if t == 0 else
                 [(rand(p), rand(p)) for _ in range(9)])
        cases.append(f"mds {f} " + " ".join(f"{_hex(x)} {_hex(y)}"
                                            for x, y in prods))
        want.append(sum(x * y for x, y in prods) * rinv % p)
    got = [_int(o.split()) for o in _run(cases)]
    assert got == want


def test_emulated_curve_adds_match_twins():
    """full_add and mixed_add on projective points (identity either side,
    doubling, inverse) equal the port's twins word for word."""
    rng = np.random.default_rng(31)
    pts = [ff.g1_mul(ff.G1_GEN, int(rng.integers(1, 1 << 62))) for _ in range(16)]
    a = pts[:8] + [None, pts[0], None, pts[1], pts[2]]
    b = pts[8:] + [pts[3], None, None, pts[1], ff.g1_neg(pts[2])]
    pa = cv.full_add(cv.from_affine_ints(a, "cpu"), cv.from_affine_ints(b, "cpu"))
    pb = cv.from_affine_ints(b, "cpu")
    live = [i for i, q in enumerate(b) if q is not None]
    lines = [f"fadd {' '.join(_tensor_hex(c[i]) for c in pa)} "
             f"{' '.join(_tensor_hex(c[i]) for c in pb)}" for i in range(len(a))]
    lines += [f"madd {' '.join(_tensor_hex(c[i]) for c in pa)} "
              f"{_tensor_hex(pb[0][i])} {_tensor_hex(pb[1][i])}" for i in live]
    out = [_words_tensor(o).reshape(3, 8) for o in _run(lines)]
    full = torch.stack(cv.full_add(pa, pb), dim=1)
    mixed = torch.stack(cv.mixed_add(tuple(c[live] for c in pa), pb[0][live],
                                     pb[1][live]), dim=1)
    assert torch.equal(torch.stack(out[: len(a)]), full)
    assert torch.equal(torch.stack(out[len(a):]), mixed)


_FB_SCALARS = {
    "edges": [0, 1, ff.R - 1, R256 - 1],        # the last: 32 digits 0xff
    "sparse": [(0x01 << 248) | (0x0203 << 120) | 0x04,  # zero digits inside
               0xFF << 128, 1 << 255],                # one nonzero digit
    "random": [int.from_bytes(np.random.default_rng(32 + i).bytes(32), "little")
               for i in range(14)],
}


@pytest.mark.parametrize("group", sorted(_FB_SCALARS))
def test_emulated_fixed_base_kernel_matches_twin(group):
    """The fixed-base kernel over a group of scalars (edge values, sparse
    digits, random 256-bit values) equals the twin word for word and the
    host scalar multiplication after normalisation."""
    scal = _FB_SCALARS[group]
    sw = fo.to_tensor(fo.ints_to_words(scal), "cpu")
    table, table_hex = _table()
    (line,) = _run([f"fb {len(scal)} {_tensor_hex(sw)} {table_hex}"])
    got = _words_tensor(line).reshape(-1, 3, 8)
    assert torch.equal(got, cv.fixed_base_plain(sw, table))
    assert cv.to_affine_ints(got.unbind(1)) == [
        ff.g1_mul(ff.G1_GEN, v) if v % ff.R else None for v in scal]
