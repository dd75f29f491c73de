"""Poseidon over BN254 Fr (T=9, RATE=8, R_F=8, R_P=63, x^5): tables, the
plain twins and the wrapper of the sponge-chain kernel (csrc/poseidon.cu).

The kernel runs a whole sponge chain of the tape in one launch: call by
call, it gathers each lane's 9-word state and up to 8 inputs from the slots
buffer (rows, lanes, 8), adds the inputs into state[1..] and the pad
marker, permutes, and scatters the state to 9 output rows; a call may read
rows an earlier call wrote. The calls are a `SpongeChain` table on the
device (`chain_table`). Round constants and the MDS matrix come from
hashes/poseidon_spec in Montgomery words.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..hashes import poseidon_spec as pspec

from ..kernels import build
from . import field as fo

T = pspec.T
RATE = pspec.RATE
HALF_F = pspec.R_F // 2
ROUNDS = pspec.R_F + pspec.R_P
FR = fo.FR


@functools.lru_cache(maxsize=1)
def table_words() -> tuple[np.ndarray, np.ndarray]:
    """(rc uint32 (71, 9, 8), mds uint32 (9, 9, 8)), Montgomery words."""
    rc, mds = pspec.generate_constants()
    rc_w = fo.ints_to_words([FR.to_mont_int(c) for row in rc for c in row])
    mds_w = fo.ints_to_words([FR.to_mont_int(c) for row in mds for c in row])
    return rc_w.reshape(ROUNDS, T, fo.WORDS), mds_w.reshape(T, T, fo.WORDS)


_TABLES: dict = {}


def tables(device) -> tuple[torch.Tensor, torch.Tensor]:
    """The tables as int32 word tensors on `device` (uploaded once)."""
    key = str(device)
    if key not in _TABLES:
        rc_w, mds_w = table_words()
        _TABLES[key] = (fo.to_tensor(rc_w, device), fo.to_tensor(mds_w, device))
    return _TABLES[key]


# -- plain twins --------------------------------------------------------------


def _sbox_h(x: torch.Tensor) -> torch.Tensor:
    x2 = fo.mont_mul_h(FR, x, x)
    x4 = fo.mont_mul_h(FR, x2, x2)
    return fo.mont_mul_h(FR, x4, x)


def permute_h(s: torch.Tensor) -> torch.Tensor:
    """Permutation on halves, state axis first: s int64 (9, ..., 16)."""
    rc, mds = tables(s.device)
    rc_h, mds_h = fo.halves(rc), fo.halves(mds)
    lead = (1,) * (s.dim() - 2)
    mds_b = mds_h.reshape(T, T, *lead, 16)
    for r in range(ROUNDS):
        s = fo.add_h(FR, s, rc_h[r].reshape(T, *lead, 16))
        if r < HALF_F or r >= HALF_F + pspec.R_P:
            s = _sbox_h(s)
        else:
            s = torch.cat([_sbox_h(s[:1]), s[1:]])
        # MDS row sums in column space, one REDC per output (< 9p^2)
        cols = fo._conv(mds_b, s.unsqueeze(0)).sum(dim=1)
        s = fo.redc(FR, cols, 3)
    return s


def sponge_call_plain(slots, st_idx, in_idx, n_in: int, pad_pos: int,
                      out_idx) -> None:
    """One call of the kernel in plain PyTorch (any device), in place."""
    s = fo.halves(slots[st_idx.long()])
    if n_in:
        ins = fo.halves(slots[in_idx[:n_in].long()])
        s = torch.cat([s[:1], fo.add_h(FR, s[1 : 1 + n_in], ins), s[1 + n_in :]])
    if pad_pos >= 0:
        one = fo.halves(fo.const(FR, 1, s.device))
        s[pad_pos] = fo.add_h(FR, s[pad_pos], one.expand_as(s[pad_pos]))
    slots[out_idx.long()] = fo.words(permute_h(s))


class SpongeChain(NamedTuple):
    """A sponge chain's call table on one device, int32: call j reads state
    rows st_idx[j] (9) and input rows in_idx[j, :n_in[j]], adds the pad
    marker at state position pad_pos[j] (-1: none) and writes rows
    out_idx[j] (9)."""

    st_idx: torch.Tensor   # (P, 9)
    in_idx: torch.Tensor   # (P, 8)
    n_in: torch.Tensor     # (P,)
    pad_pos: torch.Tensor  # (P,)
    out_idx: torch.Tensor  # (P, 9)


def chain_table(st_idx, in_idx, n_in, pad_pos, out_idx, device) -> SpongeChain:
    """Host arrays -> a checked `SpongeChain` on `device`: st_idx / out_idx
    (P, 9), in_idx (P, 8) (entries past n_in unread), n_in in 0..8, pad_pos
    in -1..8, every row index nonnegative."""
    arrs = [np.asarray(a, dtype=np.int64) for a in
            (st_idx, in_idx, n_in, pad_pos, out_idx)]
    p = len(arrs[2])
    want = ((p, T), (p, RATE), (p,), (p,), (p, T))
    if [a.shape for a in arrs] != list(want):
        raise ValueError(f"call table: want shapes {want}, got "
                         f"{[a.shape for a in arrs]}")
    n_in, pad_pos = arrs[2], arrs[3]
    if not (((n_in >= 0) & (n_in <= RATE)).all()
            and ((pad_pos >= -1) & (pad_pos < T)).all()):
        raise ValueError("call table: n_in must be in 0..8, pad_pos in -1..8")
    if any((a < 0).any() for a in (arrs[0], arrs[1], arrs[4])):
        raise ValueError("call table: negative row index")
    return SpongeChain(*(torch.from_numpy(np.ascontiguousarray(a, np.int32))
                         .to(device) for a in arrs))


def sponge_chain_plain(slots, chain: SpongeChain) -> None:
    """The kernel's semantics in plain PyTorch (any device): the calls in
    order, each through `sponge_call_plain`."""
    for j, (n_in, pad) in enumerate(zip(chain.n_in.tolist(),
                                        chain.pad_pos.tolist())):
        sponge_call_plain(slots, chain.st_idx[j], chain.in_idx[j], n_in, pad,
                          chain.out_idx[j])


# -- kernel wrapper -----------------------------------------------------------


def sponge_chain(slots: torch.Tensor, chain: SpongeChain) -> None:
    """Every call of `chain` over every lane of `slots` (rows, lanes, 8), in
    order and in place: one kernel launch on a CUDA tensor."""
    dev = slots.device
    if slots.dtype != torch.int32 or slots.dim() != 3 or slots.shape[2] != fo.WORDS:
        raise ValueError(f"slots: want int32 (rows, lanes, 8), got "
                         f"{slots.dtype} {tuple(slots.shape)}")
    if not slots.is_contiguous():
        raise ValueError("slots must be contiguous")
    p = chain.n_in.shape[0]
    for t, shape in zip(chain, ((p, T), (p, RATE), (p,), (p,), (p, T))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"call table: want int32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous() or t.device != dev:
            raise ValueError(f"call table must be contiguous on {dev}")
    if dev.type == "cpu":
        sponge_chain_plain(slots, chain)
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    rc, mds = tables(dev)
    rc_ = build.library().h2t_poseidon_chain(
        slots.data_ptr(), slots.shape[1], p,
        *(t.data_ptr() for t in chain), rc.data_ptr(), mds.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc_, "poseidon")
    build.count_launch("poseidon")

