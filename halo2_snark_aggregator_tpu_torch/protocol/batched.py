"""Batched proof aggregation on one device: record once, verify many.

Pipeline of `BatchedVerifier.verify` (the reference's
halo2_snark_aggregator_tpu/protocol/batched.py, same stages):

  1. decompress every proof point (field kernel: sqrt by a fixed power);
  2. pack the standard-form input block on the host;
  3. phase A: the compiled tape (arith/tape.py) — Montgomery conversion,
     the sponge chain (Poseidon kernel), the levelized Fr ops and batched
     inversions (field kernel) — into a slots buffer on the device;
  4. host: absorb each lane's last squeeze, squeeze lambda;
  5. phase B1: scale every MSM scalar and the leftover terms by the lanes'
     lambda powers and leave Montgomery form (field kernel);
  6. phase B2: split bucket plan on the device -> accumulate kernel ->
     reduce kernel, per MSM (w_x, w_g); the scalars never leave the device
     (the reference plans the unsigned plan on the host);
  7. host: row combine, off-curve gate, leftover generator terms,
     pairing check.

With a process `group` (the reference's `mesh=`), every rank records the
same verifier on its own device and runs phases A and B1 whole; in phase
B2 each rank builds the affine table of only its chunk of each MSM's
entries and runs the split plan and kernels over it; the ranks' rows are
all-gathered (the `gather` span of `last_profile`) and every rank
combines all of them, so each gets the same (w_x, w_g) and verdict.

`TapePoint`, `ConstPoint`, `TapeEccChip` and `RecordingTranscript` are
copies of the reference's recording classes (its module imports jax).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch

from .. import device as dv
from ..arith.tape import Slot, Tape, TapeFieldChip, compile_tape
from ..ff import bn254 as ff
from ..hashes.poseidon_chip import PoseidonChipSponge
from ..ops import curve as cv
from ..ops import field as fo
from ..ops import msm as msm_mod
from ..parallel import msm_shard
from ..transcript.host import PoseidonRead, PoseidonSponge
from . import verify as pv

FR = fo.FR
NBYTES = 32


# -- symbolic points (copied from the reference) --------------------------------

@dataclasses.dataclass(frozen=True)
class TapePoint:
    """A per-lane runtime point: `source` identifies where its affine coords
    come from at execution time. kinds: ("proof", byte_offset) |
    ("instance_commit", col)."""

    source: tuple
    x_slot: int  # tape input slots of the Fr-cast coords (for absorption)
    y_slot: int


@dataclasses.dataclass(frozen=True)
class ConstPoint:
    point: tuple  # affine ints (vk constants, generator)


class TapeEccChip:
    """Minimal pchip for the record pass: points are symbolic; only
    coordinate-absorption touches the tape."""

    def __init__(self, schip: TapeFieldChip):
        self.scalar_chip = schip
        self.native_chip = schip

    def assign_const(self, ctx, pt) -> ConstPoint:
        return ConstPoint(pt)

    def assign_var(self, ctx, pt):
        return pt  # transcripts hand us TapePoints already

    def assign_one(self, ctx) -> ConstPoint:
        return ConstPoint(ff.G1_GEN)

    def coords_in_native(self, ctx, nchip, p):
        if isinstance(p, TapePoint):
            return Slot(p.x_slot, 0), Slot(p.y_slot, 0)
        x, y = (0, 0) if p.point is None else p.point
        return (
            nchip.assign_const(ctx, x % ff.R),
            nchip.assign_const(ctx, y % ff.R),
        )


class RecordingTranscript:
    """TranscriptRead for the record pass: a host PoseidonRead walks a sample
    proof (structure only); every value read becomes a tape input with a
    manifest entry describing how to extract it from each lane's bytes."""

    def __init__(self, sample_proof: bytes, chip: TapeFieldChip, manifest: list):
        self.host = PoseidonRead(sample_proof)
        self.chip = chip
        self.manifest = manifest  # list of ("scalar"|"point", byte_offset)
        self.sponge = PoseidonChipSponge(chip, None)
        self.final_squeeze: Slot | None = None

    def read_point(self, ctx, nchip, schip, pchip) -> TapePoint:
        off = self.host.offset
        self.host.read_point()
        x_in = self.chip.assign_input(ctx)
        y_in = self.chip.assign_input(ctx)
        self.manifest.append(("point_x", off))
        self.manifest.append(("point_y", off))
        self.sponge.update([x_in, y_in])
        return TapePoint(("proof", off), x_in.idx, y_in.idx)

    def read_scalar(self, ctx, nchip, schip) -> Slot:
        off = self.host.offset
        self.host.read_scalar()
        s = self.chip.assign_input(ctx)
        self.manifest.append(("scalar", off))
        self.sponge.update([s])
        return s

    def squeeze_challenge_scalar(self, ctx, nchip, schip) -> Slot:
        self.host.squeeze_challenge()
        out = self.sponge.squeeze(ctx)
        self.final_squeeze = out
        return out

    def common_scalar(self, ctx, nchip, schip, s: Slot):
        self.sponge.update([s])

    def common_point(self, ctx, nchip, schip, pchip, p):
        x, y = pchip.coords_in_native(ctx, nchip, p)
        self.sponge.update([x, y])


# -- the verifier ---------------------------------------------------------------


class BatchedVerifier:
    """Record once per (vk, batch) on `device` (the card unless the caller
    asks for the CPU); verify many batches. With a torch.distributed
    `group`, phase B2 is sharded over its ranks (every rank calls `verify`
    with the same batch)."""

    def __init__(self, vk, params, batch: int, sample_proof: bytes,
                 sample_instances: list, msm_window: int = 8, *,
                 device="cuda", group=None):
        self.vk = vk
        self.params = params
        self.batch = batch
        self.device = dv.resolve(device)
        self.group = group
        self.msm_window = msm_window
        self.n_instances = [len(col) for col in sample_instances]
        self.last_profile: dict[str, float] = {}

        tape = Tape()
        schip = TapeFieldChip(tape)
        pchip = TapeEccChip(schip)
        manifest: list = []

        # instance scalars + instance-commitment coords as inputs
        assigned_instance_points = []
        for col, nvals in enumerate(self.n_instances):
            for i in range(nvals):
                schip.assign_input(None)
                manifest.append(("instance", (col, i)))
            x_in = schip.assign_input(None)
            manifest.append(("inst_commit_x", col))
            y_in = schip.assign_input(None)
            manifest.append(("inst_commit_y", col))
            assigned_instance_points.append(
                TapePoint(("instance_commit", col), x_in.idx, y_in.idx)
            )

        transcript = RecordingTranscript(sample_proof, schip, manifest)
        proof_ast, _advice = pv.verify_single_proof_no_eval(
            None, schip, schip, pchip,
            [assigned_instance_points], vk, params, transcript, "",
        )
        # each inner transcript is squeezed ONCE MORE after replay; that value
        # (not u) feeds the aggregation transcript (verify.rs:909-913)
        self.final_squeeze_slot = transcript.squeeze_challenge_scalar(None, schip, schip)

        one = schip.assign_const(None, 1)
        self.msm_plans = []
        for schema in (proof_ast.w_x, proof_ast.w_g):
            triples = schema.eval_prepare(None, schip, one, None)
            entries = []
            leftover = None
            for key, point, scalar in triples:
                if key == "":
                    leftover = scalar
                elif scalar is None:
                    entries.append((point, one))
                else:
                    entries.append((point, scalar))
            self.msm_plans.append((entries, leftover))

        self.tape = tape
        self.manifest = manifest
        self.run_tape = compile_tape(tape, batch, self.device)
        # phase B1 gathers: per schema, the scalar slots (entry order)
        self._scal_idx = [
            torch.tensor([e[1].idx for e in entries], dtype=torch.int32,
                         device=self.device)
            for entries, _l in self.msm_plans
        ]
        self._from_mont = fo.const(FR, 1, self.device, mont=False)

    # -- host-side packing ----------------------------------------------------
    def _decompress_all(self, proofs: list[bytes]):
        """Decompress every proof point once per verify call, batched on the
        device (ops/curve.decompress_g1_ys). Returns {(lane, byte_offset):
        affine point or None}."""
        offs = sorted({ref for kind, ref in self.manifest if kind == "point_x"})
        for entries, _l in self.msm_plans:
            for point, _s in entries:
                if not isinstance(point, ConstPoint) and point.source[0] == "proof":
                    offs.append(point.source[1])
        offs = sorted(set(offs))
        table, items = {}, []
        for b, proof in enumerate(proofs):
            for off in offs:
                raw = proof[off : off + 32]
                if raw == b"\x00" * 32:
                    table[(b, off)] = None
                    continue
                sign = (raw[31] >> 7) & 1
                x = int.from_bytes(raw[:31] + bytes([raw[31] & 0x7F]), "little")
                if x >= ff.P:
                    raise ValueError("x not canonical")
                items.append((b, off, x, sign))
        ys = cv.decompress_g1_ys([x for _b, _o, x, _s in items], self.device)
        for (b, off, x, sign), y in zip(items, ys):
            if y is None:
                raise ValueError("not on curve")
            if (y & 1) != sign:
                y = ff.P - y
            table[(b, off)] = (x, y)
        return table

    def _pack_inputs(self, proofs: list[bytes], instances_per_lane: list,
                     pt_table: dict):
        """Assemble the (manifest, B, 32) standard-byte input block. Point
        coordinates (Fq, possibly >= r) go in unreduced: phase A's
        Montgomery conversion reduces any value below 2^256."""
        B = len(proofs)
        man = self._man_index()
        out = np.zeros((B, len(self.manifest), NBYTES), dtype=np.uint8)

        # transcript scalars: one gather over the (B, L) proof byte matrix
        if len(man["scal_pos"]):
            plen = len(proofs[0])
            if any(len(p) != plen for p in proofs):
                raise ValueError("same vk => same proof length")
            pbytes = np.frombuffer(b"".join(proofs), dtype=np.uint8)
            pbytes = pbytes.reshape(B, plen)
            win = man["scal_offs"][:, None] + np.arange(NBYTES)
            out[:, man["scal_pos"]] = pbytes[:, win]

        # proof point coords (already decompressed to canonical ints)
        zero32 = bytes(NBYTES)
        for pos_key, offs_key, coord in (("ptx_pos", "ptx_offs", 0),
                                         ("pty_pos", "pty_offs", 1)):
            poss, offs = man[pos_key], man[offs_key]
            if not len(poss):
                continue
            buf = b"".join(
                zero32 if pt_table[(b, off)] is None
                else pt_table[(b, off)][coord].to_bytes(NBYTES, "little")
                for b in range(B) for off in offs)
            blk = np.frombuffer(buf, dtype=np.uint8).reshape(
                B, len(poss), NBYTES)
            out[:, poss] = blk

        # instance scalars + instance commitments (few entries; host ints),
        # with a bounded cache: tiled batches share few distinct columns
        commit_cache = getattr(self, "_commit_cache", None)
        if commit_cache is None:
            commit_cache = self._commit_cache = {}
        elif len(commit_cache) > 4096:
            commit_cache.clear()
        commits_per_lane = []
        for b, instances in enumerate(instances_per_lane):
            commits = []
            for col in instances:
                if not col:
                    commits.append(None)
                    continue
                key = tuple(col)
                if key not in commit_cache:
                    if len(col) == 1:
                        commit_cache[key] = ff.g1_mul(
                            self.params.g_lagrange[0], col[0] % ff.R)
                    else:
                        commit_cache[key] = ff.g1_msm(
                            self.params.g_lagrange[: len(col)], col)
                commits.append(commit_cache[key])
            commits_per_lane.append(commits)
            for pos, (col, i) in zip(man["inst_pos"], man["inst_ref"]):
                out[b, pos] = np.frombuffer(
                    (instances[col][i] % ff.R).to_bytes(NBYTES, "little"),
                    dtype=np.uint8)
            for pos, col, coord in man["icommit"]:
                pt = commits[col]
                v = 0 if pt is None else pt[coord]
                out[b, pos] = np.frombuffer(
                    v.to_bytes(NBYTES, "little"), dtype=np.uint8)

        words = np.ascontiguousarray(out.transpose(1, 0, 2)).view("<u4")
        return words, commits_per_lane

    def _man_index(self):
        """Per-type manifest index arrays (built once, cached)."""
        cached = getattr(self, "_man_cache", None)
        if cached is not None:
            return cached
        idx = {"scal_pos": [], "scal_offs": [], "ptx_pos": [], "ptx_offs": [],
               "pty_pos": [], "pty_offs": [], "inst_pos": [], "inst_ref": [],
               "icommit": []}
        for j, (kind, ref) in enumerate(self.manifest):
            if kind == "scalar":
                idx["scal_pos"].append(j)
                idx["scal_offs"].append(ref)
            elif kind == "point_x":
                idx["ptx_pos"].append(j)
                idx["ptx_offs"].append(ref)
            elif kind == "point_y":
                idx["pty_pos"].append(j)
                idx["pty_offs"].append(ref)
            elif kind == "instance":
                idx["inst_pos"].append(j)
                idx["inst_ref"].append(ref)
            elif kind == "inst_commit_x":
                idx["icommit"].append((j, ref, 0))
            elif kind == "inst_commit_y":
                idx["icommit"].append((j, ref, 1))
            else:
                raise KeyError(kind)
        for k in ("scal_pos", "scal_offs", "ptx_pos", "ptx_offs",
                  "pty_pos", "pty_offs", "inst_pos"):
            idx[k] = np.asarray(idx[k], dtype=np.int64)
        self._man_cache = idx
        return idx

    def _entry_points(self, proofs, commits_per_lane, pt_table: dict):
        """Resolve every MSM entry's per-lane affine point (host ints)."""
        resolved = []
        for entries, _ in self.msm_plans:
            pts = []
            for point, _scalar in entries:
                if isinstance(point, ConstPoint):
                    pts.append([point.point] * self.batch)
                else:
                    kind, ref = point.source
                    lane_pts = []
                    for b in range(self.batch):
                        if kind == "proof":
                            lane_pts.append(pt_table[(b, ref)])
                        else:
                            lane_pts.append(commits_per_lane[b][ref])
                    pts.append(lane_pts)
            resolved.append(pts)
        return resolved

    def _padded_n(self, n_entries: int) -> int:
        return 1 << max(3, (n_entries * self.batch - 1).bit_length())

    def _chunk(self, n_entries: int) -> tuple[int, int]:
        """[lo, hi) of the (entry, lane) points this rank's phase B2 takes:
        all of them, padded, without a group; else its chunk of the
        unpadded n_entries * batch."""
        if self.group is None:
            return 0, self._padded_n(n_entries)
        return msm_shard.my_chunk(n_entries * self.batch, self.group)

    # -- phase B --------------------------------------------------------------
    def _phase_b1(self, slots, lam_pows):
        """Lambda-scale and de-Montgomery every MSM scalar (entry-major,
        zero-padded, on the device) and the leftover terms, whose lane sum
        stays on the host."""
        zeros = torch.zeros(max(len(i) for i in self._scal_idx), dtype=torch.int32,
                            device=self.device)
        scalars, leftovers = [], []
        for (entries, leftover), sidx in zip(self.msm_plans, self._scal_idx):
            n = len(entries)
            scal = fo.field_op(fo.MUL, FR, slots, lam_pows, a_idx=sidx,
                               b_idx=zeros[:n])
            std = fo.field_op(fo.MUL, FR, scal, self._from_mont,
                              b_idx=zeros[:n], b_bcast=True).reshape(-1, fo.WORDS)
            pad = std.new_zeros((self._padded_n(n) - std.shape[0], fo.WORDS))
            scalars.append(torch.cat([std, pad]))
            if leftover is None:
                leftovers.append(None)
                continue
            lidx = torch.tensor([leftover.idx], dtype=torch.int32,
                                device=self.device)
            lv = fo.field_op(fo.MUL, FR, slots, lam_pows, a_idx=lidx,
                             b_idx=zeros[:1])
            lv = fo.field_op(fo.MUL, FR, lv, self._from_mont, b_idx=zeros[:1],
                             b_bcast=True)
            leftovers.append(sum(fo.words_to_ints(lv)) % ff.R)
        return scalars, leftovers

    def _phase_b2(self, tables, scalars):
        """Row totals and their windows of each MSM (the split plan), over
        this rank's chunk of the entries with a group."""
        outs = []
        for t, s, (entries, _l) in zip(tables, scalars, self.msm_plans):
            lo, hi = self._chunk(len(entries))
            outs.append(msm_shard.local_rows(t, s[lo:hi], self.msm_window))
        return outs

    # -- public API -----------------------------------------------------------
    def verify(self, proofs: list[bytes], instances_per_lane: list):
        prof = bool(os.environ.get("H2T_BV_PROFILE"))
        marks = [("start", time.perf_counter())]

        def mark(name):
            dv.synchronize(self.device)
            marks.append((name, time.perf_counter()))

        if len(proofs) != self.batch:
            raise ValueError(f"expected {self.batch} proofs, got {len(proofs)}")
        pt_table = self._decompress_all(proofs)
        mark("decompress")
        inputs, commits = self._pack_inputs(proofs, instances_per_lane, pt_table)
        mark("pack_inputs")
        slots = self.run_tape.run(fo.to_tensor(inputs, self.device))
        mark("tape_phase_a")

        # aggregation transcript: absorb per-lane final squeezes, get lambda
        outer = PoseidonSponge()
        outer.update(fo.from_mont_words(FR, slots[self.final_squeeze_slot.idx]))
        lam = outer.squeeze()
        lam_pows = fo.mont_words(
            FR, [pow(lam, self.batch - 1 - b, ff.R) for b in range(self.batch)],
            self.device).unsqueeze(0)
        mark("outer_squeeze")

        pts_resolved = self._entry_points(proofs, commits, pt_table)
        tables = []
        for pts, (entries, _l) in zip(pts_resolved, self.msm_plans):
            flat = [p for entry in pts for p in entry]  # (n*B) order: entry-major
            flat += [None] * (self._padded_n(len(entries)) - len(flat))
            lo, hi = self._chunk(len(entries))
            tables.append(msm_mod.ints_table(flat[lo:hi], self.device))
        mark("entry_points")

        scalars, leftovers = self._phase_b1(slots, lam_pows)
        mark("phase_b1")
        outs = self._phase_b2(tables, scalars)
        mark("phase_b2")
        if self.group is not None:
            outs = [msm_shard.gather_rows(*o, self.group) for o in outs]
            mark("gather")

        results = []
        for (totals, weights), e_int in zip(outs, leftovers):
            pt = msm_mod.combine_rows_host(totals.unbind(1), weights,
                                           self.msm_window)
            # kernel-health gate: every input point is curve-checked at
            # decompress, so an off-curve total can only come from broken
            # device arithmetic, never from proof data
            if pt is not None and not ff.g1_is_on_curve(pt):
                raise RuntimeError("phase-B MSM total is off-curve: kernel "
                                   "bug (not a proof failure)")
            gpt = ff.g1_mul(ff.G1_GEN, e_int) if e_int else None
            results.append((pt, gpt))
        mark("combine")

        (wx_s, wx_e), (wg_s, wg_e) = results
        w_x = ff.g1_add(wx_s, wx_e) if wx_e is not None else wx_s
        w_g = ff.g1_add(wg_s, ff.g1_neg(wg_e)) if wg_e is not None else wg_s
        ok = ff.pairing_check([
            (w_x, self.params.s_g2), (w_g, ff.g2_neg(self.params.g2)),
        ])
        mark("pairing")
        self.last_profile = {name: t1 - t0
                             for (_, t0), (name, t1) in zip(marks, marks[1:])}
        if prof:
            spans = " ".join(f"{k}={v:.3f}s" for k, v in self.last_profile.items())
            print(f"BV profile (batch {self.batch}): {spans}", file=sys.stderr)
        return w_x, w_g, ok
