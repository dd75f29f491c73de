"""BN254 Fr / Fq constants, word codecs and the plain PyTorch field arithmetic.

Representation, the same everywhere in the port: a field element is its
canonical Montgomery value a * 2^256 mod p stored as 8 little-endian 32-bit
words in the last axis of an int32 tensor, shape (..., 8). int32 holds the
uint32 bit pattern (torch has no full uint32 arithmetic); the CUDA kernels
read the same bytes as uint32_t. Standard-form values (proof bytes, MSM
scalars) use the same word layout without the Montgomery factor.

The plain functions here are the twins the kernels are held against (CPU
tests, the kernel-vs-twin checks on the card). Internally they split each
word into two 16-bit halves held in int64, so every schoolbook column sum
stays far inside int64; carries are resolved by a fixed number of
carry-save rounds and one carry-lookahead pass.
They run on any device; the kernel wrappers use them for CPU tensors.

`field_op` wraps the batched field kernel (csrc/field.cu): element
(k, lane) computes op(a[a_idx[k], lane], b[b_idx[k], lane]) and writes
out[out_idx[k], lane]. Buffers are (rows, lanes, 8); a broadcast b is
(rows, 8) and is read as b[b_idx[k]] for every lane. An index of None means
the identity. On a CUDA tensor the kernel runs; on a CPU tensor its plain
twin `field_op_plain` runs (the CPU tests' path). Nothing falls back.
`elementwise` is `field_op` on same-shape (..., 8) tensors.

`run_program` wraps the row-program kernel (csrc/field.cu
`field_program_kernel`): one straight-line program of Fr MUL / ADD / SUB
(a `RowProgram`, compiled by prover/quotient_program.py) run once per row
of n-row columns, its twin `run_program_plain` one instruction at a time
over whole columns.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ff import bn254 as ff

from ..kernels import build

WORDS = 8
NBITS = 256
_H = 16           # 16-bit halves per element
_MASK = 0xFFFF


def _int_halves(v: int) -> np.ndarray:
    return np.array([(v >> (16 * i)) & _MASK for i in range(_H)], np.int64)


class FieldSpec:
    """Per-modulus constants. `id` selects the field in the CUDA kernels
    (csrc/field.cuh FieldId)."""

    def __init__(self, modulus: int, name: str, field_id: int):
        self.modulus = modulus
        self.name = name
        self.id = field_id
        self.r_mont = (1 << NBITS) % modulus
        self.r2 = pow(1 << NBITS, 2, modulus)
        self.p_words = ints_to_words([modulus])[0]
        self.pinv32 = (-pow(modulus, -1, 1 << 32)) % (1 << 32)
        self.one_mont_words = ints_to_words([self.r_mont])[0]
        self._halves = {
            "p": _int_halves(modulus),
            "np": _int_halves((1 << NBITS) - modulus),
            "pinv": _int_halves((-pow(modulus, -1, 1 << NBITS)) % (1 << NBITS)),
            "one": _int_halves(1),
        }
        self._consts: dict = {}

    def to_mont_int(self, v: int) -> int:
        return v % self.modulus * self.r_mont % self.modulus

    def halves_const(self, name: str, device) -> torch.Tensor:
        """p, 2^256 - p, -p^-1 mod 2^256 or 1 as int64 halves on `device`
        (cached)."""
        key = (name, str(device))
        if key not in self._consts:
            self._consts[key] = torch.from_numpy(self._halves[name]).to(device)
        return self._consts[key]


# ---------------------------------------------------------------------------
# Word codecs (host)
# ---------------------------------------------------------------------------


def ints_to_words(vals) -> np.ndarray:
    """Python ints in [0, 2^256) -> uint32[n, 8] little-endian words."""
    vals = list(vals)
    if not vals:
        return np.zeros((0, WORDS), np.uint32)
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u4").reshape(len(vals), WORDS).copy()


def words_to_ints(arr) -> list[int]:
    """uint32/int32 words [..., 8] (numpy or tensor) -> flat list of ints."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    buf = np.ascontiguousarray(arr).astype("<u4", copy=False).tobytes()
    return [int.from_bytes(buf[i : i + 32], "little")
            for i in range(0, len(buf), 32)]


def to_tensor(words: np.ndarray, device) -> torch.Tensor:
    """uint32 word array -> int32 tensor with the same bits on `device`."""
    arr = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 word tensor -> uint32 numpy array with the same bits."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def const(spec: FieldSpec, value: int, device, mont: bool = True) -> torch.Tensor:
    """One element as a (1, 8) word tensor (Montgomery form by default)."""
    v = spec.to_mont_int(value) if mont else value
    return to_tensor(ints_to_words([v]), device)


def mont_words(spec: FieldSpec, ints, device) -> torch.Tensor:
    """Python ints -> canonical Montgomery words (n, 8) on `device`."""
    return to_tensor(ints_to_words([spec.to_mont_int(v) for v in ints]), device)


def from_mont_words(spec: FieldSpec, t) -> list[int]:
    rinv = pow(spec.r_mont, -1, spec.modulus)
    return [v * rinv % spec.modulus for v in words_to_ints(t)]


def words_to_canonical16(words) -> np.ndarray:
    """Standard-form words [..., 8] -> uint32[..., 16] 16-bit limbs, the
    layout of the reference's ops/field (and of its MSM planner)."""
    w = to_numpy(words) if isinstance(words, torch.Tensor) else np.asarray(words)
    w = np.ascontiguousarray(w.astype(np.uint32))
    return w.view("<u2").reshape(*w.shape[:-1], 2 * WORDS).astype(np.uint32)


FR = FieldSpec(ff.R, "Fr", 0)
FQ = FieldSpec(ff.P, "Fq", 1)


# ---------------------------------------------------------------------------
# Plain twins: 16-bit halves in int64
# ---------------------------------------------------------------------------


def halves(w: torch.Tensor) -> torch.Tensor:
    """int32 words (..., 8) -> int64 16-bit halves (..., 16)."""
    x = w.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([x & _MASK, x >> 16], dim=-1).flatten(-2)


def words(h: torch.Tensor) -> torch.Tensor:
    """Exact int64 halves (..., 16) -> int32 words (..., 8)."""
    h = h.unflatten(-1, (WORDS, 2))
    v = h[..., 0] | (h[..., 1] << 16)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook column sums of two (..., 16) int64 limb vectors:
    (..., 32) columns (broadcasting over the leading axes): column i + j
    gathers a_i b_j, added one limb of a at a time."""
    shape = torch.broadcast_shapes(a.shape, b.shape)[:-1]
    out = a.new_zeros(*shape, 2 * _H)
    for i in range(_H):
        out[..., i : i + _H] += a[..., i : i + 1] * b
    return out


def _norm(x: torch.Tensor, n: int, rounds: int) -> torch.Tensor:
    """Nonnegative int64 columns -> exact 16-bit limbs of the value mod
    2^(16n). `rounds` carry-save rounds must bring every column to at most
    2^16 (3 rounds cover columns below 2^47, 1 round columns below 2^17);
    the carries that are left ripple through 0xFFFF limbs and are resolved
    in one pass by carry lookahead."""
    if x.shape[-1] < n:
        x = torch.nn.functional.pad(x, (0, n - x.shape[-1]))
    elif x.shape[-1] > n:
        x = x[..., :n]
    for _ in range(rounds):
        c = x >> 16
        x = x & _MASK
        x[..., 1:] += c[..., :-1]
    # every limb is now <= 2^16: limb i receives a carry iff the nearest
    # limb below it that is not 0xFFFF equals 2^16. Each such limb j keys
    # 2j + (its carry out), a 0xFFFF limb -1; the running max of the keys
    # below i is the nearest one, its low bit the carry (none: -1 -> 0)
    key = torch.where(x == _MASK, -1, (x >> 16) + _even_positions(n, x.device))
    near = torch.cummax(key, dim=-1).values.clamp_(min=0) & 1
    return (x + torch.nn.functional.pad(near[..., :-1], (1, 0))) & _MASK


_EVEN: dict = {}


def _even_positions(n: int, device) -> torch.Tensor:
    """[0, 2, 4, ..., 2 (n - 1)] as int64 on `device` (cached)."""
    key = (n, str(device))
    if key not in _EVEN:
        _EVEN[key] = torch.arange(0, 2 * n, 2, dtype=torch.int64, device=device)
    return _EVEN[key]


def _cond_sub(spec: FieldSpec, r: torch.Tensor) -> torch.Tensor:
    """r - p where r >= p, else r (r exact, < 2^256): r + (2^256 - p)
    carries into limb 16 exactly when r >= p."""
    d = _norm(r + spec.halves_const("np", r.device), _H + 1, 1)
    return torch.where(d[..., _H:] != 0, d[..., :_H], r)


def redc(spec: FieldSpec, t: torch.Tensor, nsub: int) -> torch.Tensor:
    """Montgomery REDC of nonnegative columns t (value < nsub * 2^256 * p,
    columns below 2^42): exact halves of t * 2^-256 mod p (csrc/field.cuh
    `redc`). m = t * (-p^-1) mod 2^256 is taken from t's low columns as
    they are: they agree with t mod 2^256."""
    m = _norm(_conv(t[..., :_H], spec.halves_const("pinv", t.device)), _H, 4)
    u = _norm(t + _conv(m, spec.halves_const("p", t.device)), 2 * _H + 1, 3)
    r = u[..., _H : 2 * _H]
    for _ in range(nsub):
        r = _cond_sub(spec, r)
    return r


def mont_mul_h(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-256 mod p on halves; a may be unreduced (< 2^256), b < p."""
    return redc(spec, _conv(a, b), 1)


def add_h(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _cond_sub(spec, _norm(a + b, _H, 1))


def sub_h(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod p: a + (2^256 - 1 - b) + 1 carries into limb 16 exactly
    when a >= b; otherwise p is added back mod 2^256."""
    d = _norm(a + (_MASK - b) + spec.halves_const("one", a.device), _H + 1, 1)
    wrapped = _norm(d[..., :_H] + spec.halves_const("p", a.device), _H, 1)
    return torch.where(d[..., _H:] != 0, d[..., :_H], wrapped)


def pow_h(spec: FieldSpec, a: torch.Tensor, exponent: int) -> torch.Tensor:
    """a^exponent (Montgomery in/out), MSB-first square-and-multiply."""
    acc = halves(const(spec, 1, a.device)).expand_as(a).clone()
    for i in range(exponent.bit_length() - 1, -1, -1):
        acc = mont_mul_h(spec, acc, acc)
        if (exponent >> i) & 1:
            acc = mont_mul_h(spec, acc, a)
    return acc


# -- word-level twins --------------------------------------------------------


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return words(mont_mul_h(spec, halves(a), halves(b)))


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return words(add_h(spec, halves(a), halves(b)))


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return words(sub_h(spec, halves(a), halves(b)))


def pow_const(spec: FieldSpec, a: torch.Tensor, exponent: int) -> torch.Tensor:
    return words(pow_h(spec, halves(a), exponent))


def inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Fermat inversion (inv(0) = 0)."""
    return pow_const(spec, a, spec.modulus - 2)


def to_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Standard words (any value < 2^256, not necessarily reduced) ->
    canonical Montgomery words: one product by R^2 (a * R^2 < 2^256 p)."""
    return mont_mul(spec, a, const(spec, spec.r2, a.device, mont=False).expand_as(a))


def from_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Montgomery words -> canonical standard-form words (product by 1)."""
    return mont_mul(spec, a, const(spec, 1, a.device, mont=False).expand_as(a))


def to_canonical16(spec: FieldSpec, a: torch.Tensor) -> np.ndarray:
    """Montgomery words (..., 8) -> standard-form uint32[..., 16] 16-bit limbs
    (the reference's `field_rr.to_canonical16` output, the MSM planner's
    input)."""
    return words_to_canonical16(from_mont(spec, a))


# ---------------------------------------------------------------------------
# The field kernel's wrapper
# ---------------------------------------------------------------------------

MUL, ADD, SUB, POW = 0, 1, 2, 3


def _check_buf(t: torch.Tensor, name: str, ndim: int, device) -> None:
    if t.dtype != torch.int32 or t.dim() != ndim or t.shape[-1] != WORDS:
        raise ValueError(f"{name}: want int32 (..., 8) with {ndim} dims, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")


def _check_idx(idx, name: str, device) -> None:
    if idx is None:
        return
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"{name}: want contiguous int32 (n,)")
    if idx.device != device:
        raise ValueError(f"{name} on {idx.device}, expected {device}")


def _rows(t, idx, n):
    return t[:n] if idx is None else t[idx.long()]


def field_op_plain(mode: int, spec: FieldSpec, n: int, a, b, a_idx, b_idx,
                   b_bcast, out, out_idx, exponent) -> None:
    """The kernel's semantics in plain PyTorch (any device)."""
    x = _rows(a, a_idx, n)
    if mode == POW:
        r = pow_const(spec, x, exponent)
    else:
        y = _rows(b, b_idx, n)
        if b_bcast:
            y = y.unsqueeze(1).expand_as(x)
        r = {MUL: mont_mul, ADD: add, SUB: sub}[mode](spec, x, y)
    if out_idx is None:
        out[:n] = r
    else:
        out[out_idx.long()] = r


def field_op(mode: int, spec: FieldSpec, a: torch.Tensor,
             b: torch.Tensor | None = None, *, a_idx=None, b_idx=None,
             b_bcast: bool = False, out: torch.Tensor | None = None,
             out_idx=None, exponent: int | None = None) -> torch.Tensor:
    """Run one batched field op; returns `out` (allocated when None, with
    one row per element row)."""
    dev = a.device
    _check_buf(a, "a", 3, dev)
    n = next((len(i) for i in (a_idx, out_idx) if i is not None), a.shape[0])
    lanes = a.shape[1]
    if mode == POW:
        if exponent is None or not 0 <= exponent < 1 << NBITS:
            raise ValueError("pow needs an exponent in [0, 2^256)")
    else:
        if b is None:
            raise ValueError("binary op needs b")
        _check_buf(b, "b", 2 if b_bcast else 3, dev)
        if not b_bcast and b.shape[1] != lanes:
            raise ValueError("a and b disagree on lanes")
        if b_idx is not None and len(b_idx) != n:
            raise ValueError("b_idx length differs from the row count")
    for idx, name in ((a_idx, "a_idx"), (b_idx, "b_idx"), (out_idx, "out_idx")):
        _check_idx(idx, name, dev)
    if out is None:
        if out_idx is not None:
            raise ValueError("out_idx needs an out buffer")
        out = torch.empty((n, lanes, WORDS), dtype=torch.int32, device=dev)
    _check_buf(out, "out", 3, dev)
    if out.shape[1] != lanes:
        raise ValueError("a and out disagree on lanes")
    if out_idx is not None and len(out_idx) != n:
        raise ValueError("out_idx length differs from the row count")

    if dev.type == "cpu":
        field_op_plain(mode, spec, n, a, b, a_idx, b_idx, b_bcast, out,
                       out_idx, exponent)
        return out
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = build.library()
    exp_words = None
    nbits = 0
    if mode == POW:
        exp_words = ints_to_words([exponent])[0]
        nbits = exponent.bit_length()

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = lib.h2t_field(
        mode, spec.id, a.data_ptr(), ptr(a_idx), ptr(b), ptr(b_idx),
        int(b_bcast), out.data_ptr(), ptr(out_idx), n, lanes,
        None if exp_words is None else exp_words.ctypes.data, nbits,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "field")
    build.count_launch("field")
    return out


def elementwise(mode: int, spec: FieldSpec, a: torch.Tensor,
                b: torch.Tensor | None = None, *,
                exponent: int | None = None) -> torch.Tensor:
    """`field_op` on (..., 8) tensors; b broadcasts to a's shape."""
    flat = lambda t: t.reshape(-1, 1, WORDS).contiguous()  # noqa: E731
    bf = None if b is None else flat(b.expand_as(a))
    return field_op(mode, spec, flat(a), bf, exponent=exponent).reshape(a.shape)


def mont_powers(spec: FieldSpec, base: int, n: int, device) -> torch.Tensor:
    """[1, base, base^2, ..., base^(n-1)] as (n, 8) Montgomery words on
    `device`, by doubling: the known powers times base^len, two launches
    of the field kernel (its twin on the CPU) a doubling."""
    one = const(spec, 1, device)
    if n <= 1:
        return one[:n]
    p = torch.cat([one, const(spec, base, device)])
    cur = const(spec, base * base % spec.modulus, device)
    while p.shape[0] < n:
        p = torch.cat([p, elementwise(MUL, spec, p, cur.expand_as(p))])
        cur = elementwise(MUL, spec, cur, cur)
    return p[:n]


# ---------------------------------------------------------------------------
# Row programs: the field_program kernel's wrapper and its twin
# ---------------------------------------------------------------------------

PROGRAM_SLOTS = 32          # csrc/field.cu kProgSlots
SLOT, COLUMN, CONST = 0, 1, 2
_KIND_SHIFT = 28
_INDEX_MASK = (1 << _KIND_SHIFT) - 1


def operand(kind: int, index: int) -> int:
    """An instruction operand: a slot, a column reference (column,
    rotation) or a constant, by index."""
    if not 0 <= index <= _INDEX_MASK:
        raise ValueError(f"operand index {index} out of range")
    return (kind << _KIND_SHIFT) | index


@dataclasses.dataclass
class RowProgram:
    """A straight-line Fr program, run once per row i of n-row columns.

    `code` (m, 4) int32: (op, dst slot, operand a, operand b), op MUL / ADD
    / SUB, the result written to the slot after both operands are read.
    `refs` (r, 2) int32: (column, rotation); a column operand reads
    column[(i + rotation) mod n]. `consts` (c, 8) uint32: Montgomery words.
    `out` is the operand that holds the result. `n_cols` columns are given
    at each run."""

    code: np.ndarray
    refs: np.ndarray
    consts: np.ndarray
    n_cols: int
    out: int
    _tables: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.code = np.ascontiguousarray(self.code, np.int32).reshape(-1, 4)
        self.refs = np.ascontiguousarray(self.refs, np.int32).reshape(-1, 2)
        self.consts = np.ascontiguousarray(self.consts, np.uint32).reshape(-1, WORDS)
        ops = self.code[:, 0]
        if not np.isin(ops, (MUL, ADD, SUB)).all():
            raise ValueError("row program: op other than MUL, ADD, SUB")
        if ((self.code[:, 1] < 0) | (self.code[:, 1] >= PROGRAM_SLOTS)).any():
            raise ValueError(f"row program: a slot outside 0 .. {PROGRAM_SLOTS - 1}")
        if ((self.refs[:, 0] < 0) | (self.refs[:, 0] >= self.n_cols)).any():
            raise ValueError("row program: a reference to a missing column")
        limits = {SLOT: PROGRAM_SLOTS, COLUMN: len(self.refs),
                  CONST: len(self.consts)}
        for op in [self.out, *self.code[:, 2:].ravel().tolist()]:
            kind, idx = op >> _KIND_SHIFT, op & _INDEX_MASK
            if kind not in limits or idx >= limits[kind]:
                raise ValueError(f"row program: bad operand {op:#x}")

    @property
    def n_slots(self) -> int:
        return int(self.code[:, 1].max()) + 1 if len(self.code) else 0

    @property
    def products(self) -> int:
        return int((self.code[:, 0] == MUL).sum())

    def tables(self, device):
        """(code, refs, consts) as int32 tensors on `device` (cached)."""
        key = str(device)
        if key not in self._tables:
            self._tables[key] = tuple(
                torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy()).to(device)
                for a in (self.code, self.refs, self.consts))
        return self._tables[key]


def _check_columns(prog: RowProgram, cols) -> int:
    if len(cols) != prog.n_cols:
        raise ValueError(f"row program wants {prog.n_cols} columns, got {len(cols)}")
    if not cols:
        raise ValueError("row program needs at least one column")
    n = cols[0].shape[0]
    if n < 1 or n & (n - 1):
        raise ValueError(f"row count {n} is not a power of two")
    for c in cols:
        if c.dtype != torch.int32 or tuple(c.shape) != (n, WORDS):
            raise ValueError(f"column: want int32 ({n}, 8), got {c.dtype} "
                             f"{tuple(c.shape)}")
        if not c.is_contiguous():
            raise ValueError("columns must be contiguous")
        if c.device != cols[0].device:
            raise ValueError("columns on different devices")
    return n


def run_program_plain(prog: RowProgram, cols) -> torch.Tensor:
    """The row-program kernel's semantics in plain PyTorch: each instruction
    over whole columns with the plain twins, a column at rotation rot as
    `torch.roll(col, -rot)`."""
    n = _check_columns(prog, cols)
    dev = cols[0].device
    consts = to_tensor(prog.consts, dev)
    slots: list = [None] * PROGRAM_SLOTS
    rolled: dict = {}

    def value(op: int) -> torch.Tensor:
        kind, idx = op >> _KIND_SHIFT, op & _INDEX_MASK
        if kind == SLOT:
            return slots[idx]
        if kind == COLUMN:
            if idx not in rolled:
                c, rot = prog.refs[idx].tolist()
                rolled[idx] = torch.roll(cols[c], -rot, dims=0) if rot else cols[c]
            return rolled[idx]
        return consts[idx].expand(n, WORDS)

    fns = {MUL: mont_mul, ADD: add, SUB: sub}
    for op, dst, a, b in prog.code.tolist():
        slots[dst] = fns[op](FR, value(a), value(b))
    return value(prog.out).contiguous()


def run_program(prog: RowProgram, cols) -> torch.Tensor:
    """Run `prog` on every row of the (n, 8) Montgomery Fr columns `cols`;
    returns a new (n, 8) tensor. On CUDA columns: one launch of the
    row-program kernel, the columns passed as a device table of pointers."""
    n = _check_columns(prog, cols)
    dev = cols[0].device
    if dev.type == "cpu":
        return run_program_plain(prog, cols)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    code, refs, consts = prog.tables(dev)
    ptrs = torch.tensor([c.data_ptr() for c in cols], dtype=torch.int64).to(dev)
    out = torch.empty((n, WORDS), dtype=torch.int32, device=dev)
    rc = build.library().h2t_field_program(
        code.data_ptr(), len(prog.code), refs.data_ptr(), len(prog.refs),
        consts.data_ptr(), len(prog.consts), ptrs.data_ptr(), prog.out,
        out.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "field_program")
    build.count_launch("field_program")
    return out
