"""Batched proof aggregation on one device: record once, verify many.

Pipeline of `BatchedVerifier.verify` (the reference's
halo2_snark_aggregator_tpu/protocol/batched.py, same stages):

  1. decompress every proof point (field kernel: sqrt by a fixed power)
     into a table that stays on the device;
  2. pack the standard-form input block: scalars and instances from the
     host, the point coordinates scattered from that table;
  3. phase A: the compiled tape (arith/tape.py) — Montgomery conversion,
     the sponge chain (Poseidon kernel), the levelized Fr ops and batched
     inversions (field kernel) — into a slots buffer on the device;
  4. host: absorb each lane's last squeeze, squeeze lambda;
  5. phase B1: scale every MSM scalar and the leftover terms by the lanes'
     lambda powers and leave Montgomery form (field kernel);
  6. phase B2: each MSM's affine table gathered on the device from the
     call's points, the instance commitments and the key's constants;
     split bucket plan on the device -> accumulate kernel ->
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
FQ = fo.FQ
NBYTES = 32


def _at_least_p(words: np.ndarray) -> np.ndarray:
    """(n,) where the uint32 words (n, 8) hold a value >= p."""
    ge = np.ones(len(words), dtype=bool)
    for i, pw in enumerate(FQ.p_words):  # low word up; a higher word decides
        ge = (words[:, i] > pw) | ((words[:, i] == pw) & ge)
    return ge


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
        self._man = self._man_index()
        self._index_points()
        # rows of the last call's MSM tables by where they came from:
        # gathered from the device's points, or uploaded from host ints
        self.last_points: dict[str, int] = {}

    # -- the call's points ---------------------------------------------------
    def _index_points(self):
        """Every index into a call's point data, from the recorded plan and
        the batch. A call decompresses P proof points a lane, lane-major
        (row b * P + j holds lane b's point at byte offset _pt_offs[j]).
        Phase A's point rows are scattered from those rows. Each MSM plan's
        table, entry-major and padded to `_padded_n` with identity rows, is
        gathered from one source table: the B * P proof points, the B * C
        instance commitments (lane-major, C columns), the key's constant
        points (uploaded here), one identity row."""
        B, C, dev = self.batch, len(self.n_instances), self.device
        offs = {ref for kind, ref in self.manifest if kind == "point_x"}
        consts: dict = {}
        for entries, _l in self.msm_plans:
            for point, _s in entries:
                if isinstance(point, ConstPoint):
                    consts.setdefault(point.point, len(consts))
                elif point.source[0] == "proof":
                    offs.add(point.source[1])
        self._pt_offs = np.asarray(sorted(offs), dtype=np.int64)
        col = {off: j for j, off in enumerate(self._pt_offs.tolist())}
        P = len(col)

        # phase A: manifest row <- column of the (B, 2P) x-then-y table
        man = self._man
        self._pt_rows = torch.from_numpy(
            np.concatenate([man["ptx_pos"], man["pty_pos"]])).to(dev)
        self._pt_cols = torch.tensor(
            [col[o] for o in man["ptx_offs"]]
            + [P + col[o] for o in man["pty_offs"]], dtype=torch.int64,
            device=dev)

        pts = list(consts) + [None]
        xy = fo.mont_words(FQ, [0 if p is None else p[0] for p in pts]
                           + [1 if p is None else p[1] for p in pts], dev)
        self._const_x, self._const_y = xy[: len(pts)], xy[len(pts):]
        self._const_ident = torch.tensor([p is None for p in pts], device=dev)

        commit0, const0 = B * P, B * P + B * C
        lanes = np.arange(B)
        self._gather_idx, self._device_rows = [], 0
        for entries, _l in self.msm_plans:
            idx = np.full(self._padded_n(len(entries)), const0 + len(consts),
                          dtype=np.int64)
            for e, (point, _s) in enumerate(entries):
                if isinstance(point, ConstPoint):
                    row = const0 + consts[point.point]
                elif point.source[0] == "proof":
                    row = lanes * P + col[point.source[1]]
                else:
                    row = commit0 + lanes * C + point.source[1]
                idx[e * B : (e + 1) * B] = row
            lo, hi = self._chunk(len(entries))
            idx = idx[lo:hi]
            self._device_rows += int(((idx < commit0) | (idx >= const0)).sum())
            self._gather_idx.append(torch.from_numpy(idx).to(dev))

    @staticmethod
    def _proof_bytes(proofs: list[bytes]) -> np.ndarray:
        """The (B, proof_len) byte matrix of the lanes' proofs."""
        plen = len(proofs[0])
        if any(len(p) != plen for p in proofs):
            raise ValueError("same vk => same proof length")
        return np.frombuffer(b"".join(proofs), dtype=np.uint8).reshape(
            len(proofs), plen)

    def _decompress_all(self, pbytes: np.ndarray) -> cv.G1Points:
        """Decompress every proof point once per verify call, on the device
        (ops/curve.decompress_g1), rows lane-major as `_index_points` lays
        them out. x >= p (checked here, on the host's copy of the bytes) and
        x off the curve (one host read of the flags) raise ValueError."""
        enc = pbytes[:, self._pt_offs[:, None] + np.arange(NBYTES)]
        words = np.ascontiguousarray(enc).view("<u4").reshape(-1, fo.WORDS)
        x = words.copy()
        x[:, -1] &= 0x7FFFFFFF
        if (_at_least_p(x) & words.any(axis=1)).any():
            raise ValueError("x not canonical")
        pts = cv.decompress_g1(fo.to_tensor(words, self.device))
        if not bool(pts.ok.all()):
            raise ValueError("not on curve")
        return pts

    def _pack_inputs(self, pbytes: np.ndarray, instances_per_lane: list,
                     pts: cv.G1Points):
        """Phase A's (manifest, B, 8) standard-form input block on the
        device: the transcript scalars, instances and instance commitments
        from the host, then the proof point coordinates (zero for the
        identity) by one scatter from `pts`. Point coordinates (Fq, possibly
        >= r) go in unreduced: phase A's Montgomery conversion reduces any
        value below 2^256."""
        B = pbytes.shape[0]
        man = self._man
        out = np.zeros((B, len(self.manifest), NBYTES), dtype=np.uint8)

        # transcript scalars: one gather over the (B, L) proof byte matrix
        if len(man["scal_pos"]):
            win = man["scal_offs"][:, None] + np.arange(NBYTES)
            out[:, man["scal_pos"]] = pbytes[:, win]

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
        inputs = fo.to_tensor(words, self.device)
        std = torch.cat([pts.x_std.reshape(B, -1, fo.WORDS),
                         pts.y_std.reshape(B, -1, fo.WORDS)], dim=1)
        inputs[self._pt_rows] = std[:, self._pt_cols].transpose(0, 1)
        return inputs, commits_per_lane

    def _man_index(self):
        """Per-type manifest index arrays."""
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
        return idx

    def _msm_tables(self, pts: cv.G1Points, commits_per_lane: list):
        """Each MSM plan's affine table (x, y, identity) of this rank's [lo,
        hi), gathered on the device from the call's source table
        (`_index_points`): only the B * C instance commitments are uploaded
        from host ints. Sets `last_points`."""
        dev = self.device
        flat = [p for lane in commits_per_lane for p in lane]
        if len(flat) != self.batch * len(self.n_instances):
            raise ValueError("every lane needs one commitment a column")
        cxy = fo.mont_words(FQ, [0 if p is None else p[0] for p in flat]
                            + [1 if p is None else p[1] for p in flat], dev)
        one = fo.const(FQ, 1, dev)
        src_x = torch.cat([pts.x, cxy[: len(flat)], self._const_x])
        src_y = torch.cat([torch.where(pts.ident[:, None], one, pts.y),
                           cxy[len(flat):], self._const_y])
        src_i = torch.cat([pts.ident,
                           torch.tensor([p is None for p in flat], device=dev),
                           self._const_ident])
        self.last_points = {"device_rows": self._device_rows,
                            "host_rows": len(flat)}
        return [(src_x[i], src_y[i], src_i[i]) for i in self._gather_idx]

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
        pbytes = self._proof_bytes(proofs)
        pts = self._decompress_all(pbytes)
        mark("decompress")
        inputs, commits = self._pack_inputs(pbytes, instances_per_lane, pts)
        mark("pack_inputs")
        slots = self.run_tape.run(inputs)
        mark("tape_phase_a")

        # aggregation transcript: absorb per-lane final squeezes, get lambda
        outer = PoseidonSponge()
        outer.update(fo.from_mont_words(FR, slots[self.final_squeeze_slot.idx]))
        lam = outer.squeeze()
        lam_pows = fo.mont_words(
            FR, [pow(lam, self.batch - 1 - b, ff.R) for b in range(self.batch)],
            self.device).unsqueeze(0)
        mark("outer_squeeze")

        tables = self._msm_tables(pts, commits)
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
            rows = " ".join(f"{k}={v}" for k, v in self.last_points.items())
            print(f"BV profile (batch {self.batch}): {spans} {rows}",
                  file=sys.stderr)
        return w_x, w_g, ok
