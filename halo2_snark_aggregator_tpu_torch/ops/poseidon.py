"""Poseidon over BN254 Fr (T=9, RATE=8, R_F=8, R_P=63, x^5): tables, the
plain twin and the wrapper of the permutation kernel (csrc/poseidon.cu).

The kernel runs one sponge call of the tape: it gathers each lane's 9-word
state and up to 8 inputs from the slots buffer (rows, lanes, 8), adds the
inputs into state[1..] and the pad marker, permutes, and scatters the state
to 9 output rows. `permute` is the same kernel over a plain (n, 9, 8) batch.
Round constants and the MDS matrix come from hashes/poseidon_spec in
Montgomery words.
"""

from __future__ import annotations

import functools

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


# -- plain twin ---------------------------------------------------------------


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
    """The kernel's semantics in plain PyTorch (any device)."""
    s = fo.halves(slots[st_idx.long()])
    if n_in:
        ins = fo.halves(slots[in_idx[:n_in].long()])
        s = torch.cat([s[:1], fo.add_h(FR, s[1 : 1 + n_in], ins), s[1 + n_in :]])
    if pad_pos >= 0:
        one = fo.halves(fo.const(FR, 1, s.device))
        s[pad_pos] = fo.add_h(FR, s[pad_pos], one.expand_as(s[pad_pos]))
    slots[out_idx.long()] = fo.words(permute_h(s))


# -- kernel wrapper -----------------------------------------------------------


def _check_idx(idx, n: int, name: str, device) -> None:
    if idx.dtype != torch.int32 or idx.dim() != 1 or len(idx) < n:
        raise ValueError(f"{name}: want int32 (>= {n},), got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if not idx.is_contiguous() or idx.device != device:
        raise ValueError(f"{name} must be contiguous on {device}")


def sponge_call(slots: torch.Tensor, st_idx: torch.Tensor,
                in_idx: torch.Tensor | None, n_in: int, pad_pos: int,
                out_idx: torch.Tensor) -> None:
    """One sponge call over every lane of `slots` (rows, lanes, 8), in place:
    state rows st_idx (9), input rows in_idx[:n_in], pad marker added at
    state position pad_pos (-1: none), result to rows out_idx (9)."""
    dev = slots.device
    if slots.dtype != torch.int32 or slots.dim() != 3 or slots.shape[2] != fo.WORDS:
        raise ValueError(f"slots: want int32 (rows, lanes, 8), got "
                         f"{slots.dtype} {tuple(slots.shape)}")
    if not slots.is_contiguous():
        raise ValueError("slots must be contiguous")
    if not 0 <= n_in <= RATE or not -1 <= pad_pos < T:
        raise ValueError("bad n_in / pad_pos")
    _check_idx(st_idx, T, "st_idx", dev)
    _check_idx(out_idx, T, "out_idx", dev)
    if n_in:
        _check_idx(in_idx, n_in, "in_idx", dev)
    if dev.type == "cpu":
        sponge_call_plain(slots, st_idx, in_idx, n_in, pad_pos, out_idx)
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    rc, mds = tables(dev)
    rc_ = build.library().h2t_poseidon(
        slots.data_ptr(), slots.shape[1], st_idx.data_ptr(),
        in_idx.data_ptr() if n_in else None, n_in, pad_pos,
        out_idx.data_ptr(), rc.data_ptr(), mds.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc_, "poseidon")
    build.count_launch("poseidon")
