"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits nonzero):
  1. device: the card's name, power limit and top SM clock; no CUDA -> exit 2;
  2. build: nvcc builds every kernel from halo2_snark_aggregator_tpu_torch/csrc
     (one nvcc per source, in parallel), g++ the native host library; each
     kernel's registers and spill bytes from ptxas; the machine
     instructions (cuobjdump) of one Montgomery product and of each kernel;
     the card's IMAD and IMAD.WIDE.U32 rates, measured on probe chains;
  3. setup + keygen: the K=16 SRS (one fixed-base launch, no padd launch)
     and the zkevm-shape key built on the card, device commits, fingerprint
     checked; launch counts read for that path;
  4. kernel vs plain twin, at the main paths' shapes, exact equality: field
     mul/add/sub (the verifier's widest tape level x 128 lanes and the
     prover's 2^16-element polynomials), pow (Fr inversions, Fq square
     roots), 4b the Poseidon sponge chain on the verifier's call table at
     128 lanes (the whole chain in one launch against the twin run on the
     CPU, then timed) and one call alone, 4c the MSM split plan, accumulate
     and reduce at one commit of the prover (2^16 SRS points, c=8: the plan
     built on the card against the numpy copy's, the row combine against
     the native MSM; max bucket load, max row load, rows, the plan's time),
     4d padd on 2^14 special pairs (identities, doubling, inverse) and on
     the first level (2^20 pairs) of a tree of adds over the K=16 SRS's
     digit points, whose normalised sum must be the SRS of phase 3 word for
     word; the fixed-base kernel over the same 2^16 tau powers and on
     special scalars against its twin, timed beside the tree; 4e the
     batched transform at k=16 (one vector forward and inverse; the
     quotient shard's batch of columns with a coset factor, forward, and
     inverse with the 1/n scale in its last pass; forward == native
     fr_ntt, inverse(forward) == input; the inverse's time less the
     forward's), 4f the row-program kernel on the K=16 quotient program
     over random columns;
  5. parity: the batched verifier over the 4 committed proofs must give the
     host value-context oracle's (w_x, w_g) and pass;
  6. main verify path: batch 128 (4 proofs tiled 32x), one warm and REPS
     timed verifies, with every kernel of the path launched and the sponge
     chain launched once a verify; then one verify under torch.profiler
     (device busy share, device time by kernel);
  7. negative: one flipped transcript-scalar byte must fail the verify;
  8. prove: fixture proof 0 made on the card with device commits must equal
     the committed bytes; stage split, launches, commit loads and split, the
     host vs device commit A/B on one 2^16-scalar vector; then that proof with
     fixtures 1-3 through the batch-4 verifier, equal to the oracle;
  9. K=18: the 131-column zkevm-shape workload (fixtures.WORKLOADS[18]).
     9a the 2^18 SRS and the key on the card, fingerprint 767a119919e3df76;
     9b proof 0 with device commits equal to the committed bytes, seconds
     and peak device bytes by stage, the working set and the k=22
     aggregator's estimate against the 72 GB spill limit; every kernel at
     its K=18 shape against its twin: 9c the fixed-base sum over the 2^18
     tau powers (built on the card == the host list) and the field kernel at
     2^18, 9d the plan built on the card == the host plan and the transform
     over the quotient's 321 columns (the twin on three of them), 9e the
     1,375-instruction row program (the twin over 4,096 rows), 9f one 2^18
     commit (plan, accumulate, reduce against their twins, the total against
     the native MSM), 9g the sponge chain of the K=18 verifier; 9h the
     batched verifier: batch 2 == the value oracle, batch 128 (the proof
     tiled as the bench tiles it) passes and is timed, a flipped byte fails;
     the hybrid chips at their default `device_min` over 2 K=18 proofs ==
     the value oracle, their large MSM on the card, both timed;
 10. k=22: the SRS built on the card, cached and loaded back, a few rows
     against the host g1_mul, the fixed-base kernel over its 2^22 tau
     powers against its twin (on a slice); one commit of 2^22 random
     scalars against the native host Pippenger, its split by phase and its
     largest row load; on that commit's plan the accumulate and reduce
     kernels against their twins on the card over its rows (the one with
     the most adds, the first, the last; the accumulate's twin replayed as
     a CUDA graph, itself held against the eager twin), both timed; the NTT
     plan built on the card == the host plan, and one 2^22 vector through the three-pass transform == its twin,
     inverse(forward) == x;
 11. the SDK (sdk/harness.py, sdk/cli.py) on the card: 11a `msm_ints`
     against the native g1_msm at n = 2^4..2^16, equal and timed, the
     crossover (the hybrid chips' `device_min`); 11b
     `verify_aggregation_proofs_in_chip` over `make_device_chips` with
     every multi_exp on the card over the four K=16 proofs == the value
     oracle's pair, then the CLI's sample_setup, sample_run and
     verify_check on a fresh folder under a temp dir == the value pair
     (the demo's MSM sizes beside `device_min`: they stay on the host); 11c verify_setup at agg_k=22 (seconds, keygen spans and peak bytes,
     the vk's fingerprint); 11d verify_run at agg_k=22 (the same vk; proof
     bytes, seconds, spans, commit split, peak bytes beside the estimate;
     the aggregator's quotient program over 4,096 rows, its 44-column
     transform and the field kernel at 2^22 against their twins); 11e
     verify_check_outer passes, a flipped byte fails; 11f the CLI's
     verify_check with the stored outer proof; 11b' (after 11b, before any
     outer proof is stored) the CLI's verify_solidity target flow with
     sha256 and keccak256, the card's proof equal to the host prover's; 11g
     verify_solidity over 11d's outer proof: both sources checked, linted,
     written and executed (the proof and verify_final_pair accepted, a
     flipped proof word rejected), their sizes against EIP-170's 24,576 B;
 12. the second recursion layer: one demo target proof, the layer-1 outer
     proof with the Poseidon transcript at k=20 (verify_check_l1_poseidon
     passes, a flipped byte fails), the layer-2 circuit's rows from one
     keygen synthesis and l2_k the least k that holds them, the CLI's
     verify2_run at l2_k (spans and peaks by StageTimer), verify2_check
     passes and a flipped byte fails, the CLI's verify2_check;
 13. the sharded paths (parallel/), each against the unsharded one, over a
     1-rank NCCL group in this process and over worlds of gloo ranks that
     share the card (parallel/group.spawn, one process a rank): 13a the
     sharded MSM of the K=18 SRS's 2^18 points == msm_totals + the row
     combine == the native Pippenger; 13b the four-step NTT at k=22,
     forward and inverse, == ntt_batch word for word; 13c
     BatchedVerifier(group=) at K=16 batch 128 on 2 ranks: phase 6's pair,
     the pairing passes, a flipped byte fails on both, proofs/s beside
     phase 6's; 13d the two-level MSM on 4 ranks (2 hosts x 2 chips) ==
     13a; 13e verify_check(group=) over the four K=16 proofs on 2 ranks,
     every MSM sharded == 11b's pair; 13f the shuffle and synthetic
     circuits' proofs made on the card == the host prover's bytes. The
     ranks' launches enter the kernels line as the shard_* paths; every
     rank checks that it imported no JAX.
Then a JSON line of the K=18 proof's and verifier's numbers, the 2^22
commit's, the SDK's and phase 13's, a JSON line of the kernels (per launch: `ms`, torch.profiler's device
time; `launch_ms`, CUDA events around the Python calls, the host's launch
rate for short kernels; the twin's time and the bound; the launches on each
path; their registers and spills from ptxas and machine instructions; for
the sponge, the whole chain's times; for the accumulate, the plan's time;
for the fixed-base sum, the padd tree's time; for the transform, one
vector's times beside the batch's and the inverse's, and the inverse's
extra time, which holds the 1/n epilogue; for the row
program, its size; under `k18`, each kernel's launches on the K=18
paths and its check at the K=18 shape; under `sdk`, its launches on the
SDK's paths of phases 10-11 and its check at the k=22 aggregator's
shape; phase 13's launches are its `shard_*` and `prove_extra` paths'
`launches_by_path` entries), the nvidia-smi line, and the
final JSON line
{"ok": true, "device": {...}}. The script fails if jax or any module of the
JAX package was imported.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 20261016
REPS = 3
PROFILE_TRIES = 5       # profiles of one kernel at most
PADD_PAIRS = 1 << 14    # special cases: identities, P + P, P + (-P)
PLAIN_CHUNK = 1 << 18   # rows per call of a twin at the prover's sizes
NTT_K = 16

# Bounds: the least time the card could take, the larger of bytes over the
# memory rate and 32-bit integer multiply-adds over the IMAD rate.
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
IMAD_PER_CLOCK_PER_SM = 64      # 32-bit IMAD, compute capability 9.0
# one Montgomery product on 8 x 32-bit words: 64 32x32->64 multiply-adds for
# a * b and 8 * (1 + 8) for REDC, each 64-bit product two 32-bit IMADs
MONT_MUL_IMAD = 2 * 64 + (8 + 2 * 64)
FULL_ADD_MULS = 12              # RCB15 Algorithm 7
MIXED_ADD_MULS = 11             # RCB15 Algorithm 8

# every kernel of the port: its source and the TPU kernel it replaces (the
# fixed-base sum carries the SRS's tree of curve_pallas adds; the transform's
# last pass of an inverse also carries ntt_pallas `_scale_kernel`, :179)
KERNEL_SOURCES = {
    "field": ("field.cu", "ops/field_pallas.py:106"),
    "field_program": ("field.cu", "ops/field_pallas.py:106"),
    "poseidon": ("poseidon.cu", "ops/poseidon_pallas.py:94"),
    "msm_accumulate": ("msm.cu", "ops/msm_pallas.py:252"),
    "msm_reduce": ("msm.cu", "ops/msm_pallas.py:285"),
    "curve_padd": ("curve.cu", "ops/curve_pallas.py:147"),
    "fixed_base": ("curve.cu", "ops/curve_pallas.py:147"),
    "ntt_transform": ("ntt.cu", "ops/ntt_pallas.py:168"),
}
PTXAS_SYMBOL = {"field": "field_kernel",
                "field_program": "field_program_kernel",
                "poseidon": "poseidon_chain_kernel",
                "msm_accumulate": "accumulate_kernel",
                "msm_reduce": "reduce_kernel",
                "curve_padd": "padd_kernel",
                "fixed_base": "fixed_base_kernel",
                "ntt_transform": "ntt_pass_kernel"}
# the kernels each path must launch (the batched padd is on none of them:
# the SRS is one fixed-base launch)
PATH_KERNELS = {
    "setup_keygen": ("fixed_base", "field", "ntt_transform", "msm_accumulate",
                     "msm_reduce"),
    "verify": ("field", "poseidon", "msm_accumulate", "msm_reduce"),
    "prove": ("field", "field_program", "ntt_transform", "msm_accumulate",
              "msm_reduce"),
}
PATH_KERNELS.update(setup_keygen_k18=PATH_KERNELS["setup_keygen"],
                    prove_k18=PATH_KERNELS["prove"],
                    verify_k18=PATH_KERNELS["verify"],
                    hybrid_k18=("msm_accumulate", "msm_reduce"),
                    # phase 10-11: the SDK's paths (the aggregator at k=22)
                    setup_k22=("fixed_base", "field"),
                    hybrid_k16=("msm_accumulate", "msm_reduce"),
                    sdk_sample=PATH_KERNELS["prove"],
                    verify_setup_k22=("field", "ntt_transform",
                                      "msm_accumulate", "msm_reduce"),
                    verify_run_k22=PATH_KERNELS["prove"],
                    # phase 11b' and 12: verify_solidity's target proofs,
                    # the layer-1 SRS and outer proof, the layer-2 proof
                    sdk_solidity=PATH_KERNELS["prove"],
                    setup_k20=("fixed_base", "field"),
                    l1_run_k20=PATH_KERNELS["prove"],
                    l2_run=PATH_KERNELS["prove"],
                    # phase 13: the sharded paths (the ranks' launches
                    # summed) and the two new circuits' proofs
                    shard_msm_nccl=("msm_accumulate", "msm_reduce"),
                    shard_ntt_nccl=("ntt_transform", "field"),
                    shard_msm=("msm_accumulate", "msm_reduce"),
                    shard_ntt=("ntt_transform", "field"),
                    shard_verify=PATH_KERNELS["verify"],
                    shard_hybrid=("msm_accumulate", "msm_reduce"),
                    shard_hier=("msm_accumulate", "msm_reduce"),
                    prove_extra=PATH_KERNELS["prove"])
AGG_K = 22
L1_K = 20               # the layer-1 outer proof of phase 12 (bench.py:514)
L2_K = 21               # its layer 2: 2,056,353 rows, measured on the card
SHARD_NTT_K = 22        # phase 13b: the outer proof's transform size
SHARD_TIMEOUT = 150.0   # phase 13: a world's deadline and its groups' timeout
CROSSOVER_REPS = 3


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean time of one call of `fn` over `reps` runs after one warm run,
    CUDA events: for a short kernel this is the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, symbol: str, reps: int, launches: int = 1) -> float:
    """Device ms per call of `fn`, which launches the CUDA function `symbol`
    `launches` times, over `reps` runs after one warm run: torch.profiler's
    device time (CUDA activity only), which the host's launch rate does not
    hold back, as the mean of the recorded launches times `launches`. Late
    in a long run the card's tracer drops a few records a profile, so one
    with fewer than reps * launches records is taken again, up to
    PROFILE_TRIES profiles; the first whole one counts, else the fullest,
    and a line gives the records of each try."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    pat = re.compile(r"(^|\s)h2t::" + symbol + r"[<(]")  # csrc's namespace
    want = reps * launches
    best, tries = (0, 0.0), []
    for _ in range(PROFILE_TRIES):
        torch.cuda.empty_cache()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us, count = 0.0, 0
        for ev in prof.key_averages():
            if pat.search(ev.key):
                total_us += ev.self_device_time_total
                count += ev.count
        if count > want:
            raise AssertionError(f"{count} launches of {symbol} in {reps} "
                                 f"calls, not {want}")
        tries.append(count)
        if total_us > 0 and count > best[0]:
            best = (count, total_us)
        if count == want:
            break
    count, total_us = best
    if not count:
        raise AssertionError(f"torch.profiler saw no device time for {symbol} "
                             f"in {PROFILE_TRIES} profiles")
    if len(tries) > 1:
        phase("profile", f"{symbol}: records of {want} in each try {tries}; "
              f"the time is the mean of {count} x {launches}")
    return total_us / 1e3 / count * launches


def timed(fn, symbol: str, reps: int) -> dict:
    """Device ms per launch (`ms`) and CUDA-event ms per call (`launch_ms`)."""
    return dict(ms=kernel_ms(fn, symbol, reps), launch_ms=cuda_ms(fn, reps))


def once_ms(fn):
    """(fn(), CUDA-event ms of that one call): for twins too slow to warm."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


class Bounds:
    """bound_ms of a launch from its bytes and IMADs on this card."""

    def __init__(self, sms: int, clock_mhz: float):
        self.imad_per_s = sms * IMAD_PER_CLOCK_PER_SM * clock_mhz * 1e6

    def __call__(self, nbytes: float, imads: float) -> tuple[float, str]:
        t_mem = nbytes / HBM_BYTES_PER_S
        t_ops = imads / self.imad_per_s
        return (max(t_mem, t_ops) * 1e3,
                "bytes" if t_mem >= t_ops else "operations")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def rand_ints(modulus: int, n: int, rng) -> list[int]:
    raw = rng.integers(0, 1 << 63, size=(n, 4), dtype=np.uint64)
    return [(int(r[0]) | int(r[1]) << 64 | int(r[2]) << 128 | int(r[3]) << 192)
            % modulus for r in raw]


def rand_field(spec, shape, rng, device):
    """Canonical Montgomery words of uniform field elements, shape + (8,)."""
    from halo2_snark_aggregator_tpu_torch.ops import field as fo

    vals = rand_ints(spec.modulus, int(np.prod(shape)), rng)
    return fo.to_tensor(fo.ints_to_words(vals), device).reshape(*shape, 8)


def rand_fr_bulk(shape, rng, device) -> torch.Tensor:
    """Canonical Fr words, shape + (8,), made in bulk on `device` from a
    generator seeded by `rng`: uniform words with the top word below r's
    (so every value is below r)."""
    from halo2_snark_aggregator_tpu_torch.ops import field as fo

    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(1 << 62)))
    w = torch.randint(0, 1 << 32, (*shape, 8), dtype=torch.int64,
                      generator=gen, device=device)
    w[..., 7] %= int(fo.FR.p_words[7])
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def value_oracle(params, vk, proofs, insts, chips=None):
    """(w_x, w_g) of the host value-context aggregation verifier, or of the
    same verifier on `chips` (`make_device_chips`' four) when given."""
    from halo2_snark_aggregator_tpu_torch.arith.value import ValueContext, ValueEccChip
    from halo2_snark_aggregator_tpu_torch.protocol import verify as pv
    from halo2_snark_aggregator_tpu_torch.protocol.transcript import PoseidonTranscriptRead

    if chips is None:
        pchip = ValueEccChip()
        chips = (ValueContext(), pchip.scalar_chip, pchip.scalar_chip, pchip)
    ctx, nchip, schip, pchip = chips
    pdata = [pv.ProofData(instances=[inst],
                          transcript=PoseidonTranscriptRead(p, ctx, nchip),
                          key=f"p{i}")
             for i, (p, inst) in enumerate(zip(proofs, insts))]
    agg = PoseidonTranscriptRead(b"", ctx, nchip)
    cp = pv.CircuitProof(name="zkevm", vk=vk, params=params, proofs=pdata)
    w_x, w_g, *_rest, ok = pv.verify_aggregation_proofs_in_chip(
        ctx, nchip, schip, pchip, [cp], agg)
    if not ok:
        raise AssertionError("the aggregation verifier rejected the fixture "
                             "proofs")
    return w_x, w_g


def check_field(dev, rng, bv, bound, results):
    from halo2_snark_aggregator_tpu_torch.ff import bn254 as ff
    from halo2_snark_aggregator_tpu_torch.ops import field as fo

    lanes = bv.batch
    width = max(len(s[2]) for s in bv.run_tape.steps if s[0] == "ops")
    inv_width = max(len(s[1]) for s in bv.run_tape.steps if s[0] == "inv")
    n_pts = len({ref for kind, ref in bv.manifest if kind == "point_x"})
    src = rand_field(fo.FR, (2 * width, lanes), rng, dev)
    perm = [torch.from_numpy(rng.permutation(2 * width)[:width].astype(np.int32)).to(dev)
            for _ in range(3)]
    errs, times = [], {}
    for mode, name in ((fo.MUL, "mul"), (fo.ADD, "add"), (fo.SUB, "sub")):
        out_k = torch.zeros_like(src)
        out_p = torch.zeros_like(src)

        def run_k():
            fo.field_op(mode, fo.FR, src, src, a_idx=perm[0], b_idx=perm[1],
                        out=out_k, out_idx=perm[2])

        def run_p():
            fo.field_op_plain(mode, fo.FR, width, src, src, perm[0], perm[1],
                              False, out_p, perm[2], None)

        times[name] = (timed(run_k, "field_kernel", 20), cuda_ms(run_p, 1))
        errs.append(max_abs_err(out_k, out_p))
    # the prover's shape: (2^16, 8) Fr polynomials through fo.elementwise
    n_poly = 1 << NTT_K
    pa = rand_field(fo.FR, (n_poly,), rng, dev)
    pb = rand_field(fo.FR, (n_poly,), rng, dev)
    for mode, name in ((fo.MUL, "prove_mul"), (fo.ADD, "prove_add"),
                       (fo.SUB, "prove_sub")):
        out_p = torch.empty((n_poly, 1, 8), dtype=torch.int32, device=dev)

        def run_p():
            fo.field_op_plain(mode, fo.FR, n_poly, pa.reshape(n_poly, 1, 8),
                              pb.reshape(n_poly, 1, 8), None, None, False,
                              out_p, None, None)

        def run_k():
            return fo.elementwise(mode, fo.FR, pa, pb)

        run_p()
        errs.append(max_abs_err(run_k(), out_p.reshape(n_poly, 8)))
        times[name] = (timed(run_k, "field_kernel", 20), cuda_ms(run_p, 3))
    # std -> Montgomery on unreduced operands (phase A feeds Fq coordinates
    # below 2^256 into Fr slots): a * R^2 with a up to 2^256 - 1
    vals = [(1 << 256) - 1, ff.P, ff.R, 2 * ff.R, ff.P - 1, 0]
    vals += [int.from_bytes(rng.bytes(32), "little") for _ in range(lanes - len(vals))]
    std = fo.to_tensor(fo.ints_to_words(vals), dev).reshape(-1, 1, 8)
    r2 = fo.const(fo.FR, fo.FR.r2, dev, mont=False)
    zeros = torch.zeros(len(vals), dtype=torch.int32, device=dev)
    mont_k = fo.field_op(fo.MUL, fo.FR, std, r2, b_idx=zeros, b_bcast=True)
    mont_p = torch.empty_like(std)
    fo.field_op_plain(fo.MUL, fo.FR, len(vals), std, r2, None, zeros, True,
                      mont_p, None, None)
    errs.append(max_abs_err(mont_k, mont_p))
    if fo.from_mont_words(fo.FR, mont_k) != [v % ff.R for v in vals]:
        raise AssertionError("field kernel: std -> Montgomery of unreduced "
                             "operands is wrong")
    for spec, exp, n, name in ((fo.FR, ff.R - 2, inv_width, "pow_fr_inv"),
                               (fo.FQ, (ff.P + 1) // 4, n_pts, "pow_fq_sqrt")):
        a = rand_field(spec, (n, lanes), rng, dev)
        out_k = torch.empty_like(a)
        out_p = torch.empty_like(a)

        def run_k():
            fo.field_op(fo.POW, spec, a, out=out_k, exponent=exp)

        def run_p():
            fo.field_op_plain(fo.POW, spec, n, a, None, None, None, False,
                              out_p, None, exp)

        times[name] = (timed(run_k, "field_kernel", 5), cuda_ms(run_p, 1))
        errs.append(max_abs_err(out_k, out_p))
    err = max(errs)
    if err:
        raise AssertionError(f"field kernel differs from its twin: {err}")
    shapes = (f"verify: widest level {width} x {lanes}, inversions {inv_width} "
              f"x {lanes}, sqrt {n_pts} x {lanes}; prove: 2^{NTT_K} x 8 words")
    phase("4a field", f"exact (and on {len(vals)} unreduced operands up to "
          f"2^256-1); {shapes}; device ms per launch (launch ms, plain ms): "
          + ", ".join(f"{k} {t['ms']:.4f} ({t['launch_ms']:.4f}, {p:.2f})"
                      for k, (t, p) in times.items()))
    mul, mul_plain = times["prove_mul"]
    results["field"] = dict(
        max_abs_err=err, plain_ms=mul_plain, **mul,
        detail={k: dict(t, plain_ms=p) for k, (t, p) in times.items()},
        shape=f"mul 2^{NTT_K} x 8 words (the prover's elementwise)",
        bound=bound(n_poly * 96, n_poly * MONT_MUL_IMAD))


def poseidon_depth(one_thread: bool = False) -> int:
    """Dependent steps (one 256 x 256-bit product or one REDC each) on a
    state's critical path through one permutation. With one thread per
    state, a full round's 9 S-boxes run one after another, then 81 products
    and 9 REDCs; with a thread per element (csrc/poseidon.cu) a round is one
    S-box (3 Montgomery products), 9 products and 1 REDC."""
    from halo2_snark_aggregator_tpu_torch.hashes import poseidon_spec as pspec

    t, sbox = pspec.T, 3 * 2
    if one_thread:
        full, partial = t * sbox + t * t + t, sbox + t * t + t
    else:
        full = partial = sbox + t + 1
    return pspec.R_F * full + pspec.R_P * partial


def reduce_depth(nbuckets: int) -> int:
    """Dependent complete adds on a window's critical path in the scan
    reduce (csrc/msm.cu): 3 (L - 1) + 2 ceil(log2 T)."""
    from halo2_snark_aggregator_tpu_torch.ops import msm as pm

    nt, seg = pm.reduce_shape(nbuckets)
    return 3 * (seg - 1) + 2 * (nt - 1).bit_length()


def poseidon_imads() -> int:
    """IMADs of one T=9 permutation: x^5 is 3 products; the MDS is 81 wide
    products and one REDC per output (csrc/poseidon.cu)."""
    from halo2_snark_aggregator_tpu_torch.hashes import poseidon_spec as pspec

    t = pspec.T
    mds = t * t * 2 * 64 + t * (8 + 2 * 64)
    full = t * 3 * MONT_MUL_IMAD + mds
    partial = 3 * MONT_MUL_IMAD + mds
    return pspec.R_F * full + pspec.R_P * partial


def check_poseidon(dev, rng, bv, bound, results, tag="4b poseidon",
                   twin_lanes=None):
    """The sponge-chain kernel on the verifier's own call table at its batch
    (the compiled tape of phase 6): the whole chain in one launch against
    the twin run on the CPU (where its many small ops run faster) over the
    first `twin_lanes` lanes (default all), then timed; then one call
    alone, two absorb cases against the twin on the card, the first timed
    (the kernel's `ms` and the twin's `plain_ms`)."""
    from halo2_snark_aggregator_tpu_torch.ops import field as fo
    from halo2_snark_aggregator_tpu_torch.ops import poseidon as po

    chain, lanes = bv.run_tape.sponge, bv.batch
    n_calls = chain.n_in.shape[0]
    base = rand_field(fo.FR, (bv.run_tape.n_slots, lanes), rng, dev)
    tl = lanes if twin_lanes is None else twin_lanes
    buf_k, buf_p = base.clone(), base[:, :tl].cpu()
    po.sponge_chain(buf_k, chain)
    po.sponge_chain_plain(buf_p, po.SpongeChain(*(t.cpu() for t in chain)))
    errs = [max_abs_err(buf_k[:, :tl].cpu(), buf_p)]
    t_chain = timed(lambda: po.sponge_chain(buf_k, chain),
                    "poseidon_chain_kernel", 5)
    one = rand_field(fo.FR, (26, lanes), rng, dev)
    times = []
    for n_in, pad in ((8, -1), (3, 4)):
        call = po.chain_table([range(9)], [range(9, 17)], [n_in], [pad],
                              [range(17, 26)], dev)
        buf_k, buf_p = one.clone(), one.clone()
        po.sponge_chain(buf_k, call)
        _out, plain_ms = once_ms(lambda: po.sponge_chain_plain(buf_p, call))
        errs.append(max_abs_err(buf_k, buf_p))
        times.append((timed(lambda: po.sponge_chain(buf_k, call),
                            "poseidon_chain_kernel", 10), plain_ms))
    err = max(errs)
    if err:
        raise AssertionError(f"poseidon kernel differs from its twin: {err}")
    t, plain_ms = times[0]
    phase(tag, f"exact on all {n_calls} of the verifier's calls x "
          f"{tl} of {lanes} lanes (one launch against the twin on the CPU) "
          f"and on one "
          f"call (8 inputs; 3 inputs + pad); whole chain {t_chain['ms']:.4f} "
          f"ms device in one launch ({t_chain['ms'] / n_calls:.4f} ms a call, "
          f"{t_chain['launch_ms']:.4f} ms launch); one call {t['ms']:.4f} ms "
          f"device, {t['launch_ms']:.4f} ms launch (plain {plain_ms:.2f} ms); "
          f"depth {poseidon_depth()} steps a call (one thread a state: "
          f"{poseidon_depth(one_thread=True)})")
    results["poseidon"] = dict(
        max_abs_err=err, plain_ms=plain_ms, **t, chain_calls=n_calls,
        chain_ms=t_chain["ms"], chain_launch_ms=t_chain["launch_ms"],
        shape=f"one call, {lanes} states (chain: {n_calls} calls a launch)",
        bound=bound(lanes * 26 * 32, lanes * poseidon_imads()))


def check_msm(dev, rng, params, bound, results, tag="4c msm"):
    """The split plan and the accumulate and reduce kernels at one commit of
    the prover: the params' 2^k-point affine SRS table, c = 8, uniform
    scalars.
    The plan built on the card must equal the numpy copy's; each kernel
    its twin on the card; the row combine the native MSM."""
    from halo2_snark_aggregator_tpu_torch import device as dv
    from halo2_snark_aggregator_tpu_torch.ff import bn254 as ff
    from halo2_snark_aggregator_tpu_torch.ops import field as fo
    from halo2_snark_aggregator_tpu_torch.ops import msm as pm

    n, c = params.n, params.msm_window
    scal = rand_ints(ff.R, n, rng)
    words = fo.ints_to_words(scal)
    std = fo.to_tensor(words, dev)
    tx, ty, _ident = params.table()
    stats = {}
    plan = pm.bucket_plan_split(std, c, stats=stats)
    host = pm.host_bucket_plan_split(fo.words_to_canonical16(words), c)
    if not all(np.array_equal(g.cpu().numpy(), h) for g, h in zip(plan, host)):
        raise AssertionError("the plan built on the card differs from the "
                             "numpy copy's")
    plan_ms = cuda_ms(lambda: pm.bucket_plan_split(std, c), 5)
    plan_dev_ms = dv.profile_device(lambda: pm.bucket_plan_split(std, c),
                                    dev)["device_busy_s"] * 1e3
    rows, nb = plan[2].shape
    acc_k = pm.accumulate(tx, ty, *plan)
    acc_p, acc_plain_ms = once_ms(lambda: pm.accumulate_plain(tx, ty, *plan))
    err_a = max_abs_err(acc_k, acc_p)
    tot_k = pm.reduce(acc_k, rows, nb)
    tot_p, red_plain_ms = once_ms(lambda: pm.reduce_plain(acc_k, rows, nb))
    err_r = max_abs_err(tot_k, tot_p)
    if err_a or err_r:
        raise AssertionError(f"msm kernels differ from their twins: {err_a}, {err_r}")
    got = pm.combine_rows_host(tot_k.unbind(1), plan[3], c)
    if got != ff.g1_msm(params.g_host_points(), scal):
        raise AssertionError("msm total differs from the native MSM")
    ta = (timed(lambda: pm.accumulate(tx, ty, *plan), "accumulate_kernel", 5),
          acc_plain_ms)
    tr = (timed(lambda: pm.reduce(acc_k, rows, nb), "reduce_kernel", 5),
          red_plain_ms)
    adds = stats["adds"]
    lanes = rows * nb
    acc_bound = bound(n * 64 + plan[0].numel() * 4 + lanes * 8 + rows * 4
                      + lanes * 96, adds * MIXED_ADD_MULS * MONT_MUL_IMAD)
    phase(tag, f"split plan on the card == numpy copy's; exact over {n} "
          f"points, c={c}, max bucket load {stats['max_load']}, max row load "
          f"{stats['max_row_load']} (target {stats['target']}), {rows} rows, "
          f"{lanes} lanes ({int((plan[2] > 0).sum())} with points), {adds} "
          f"adds; total == native g1_msm; plan {plan_ms:.3f} ms (events, its "
          f"host sync included; {plan_dev_ms:.3f} ms device); accumulate {ta[0]['ms']:.3f} ms device, "
          f"{ta[0]['launch_ms']:.3f} ms launch (plain {ta[1]:.1f} ms, bound "
          f"{acc_bound[0]:.3f} ms); reduce over {rows} rows {tr[0]['ms']:.3f} "
          f"ms device (plain {tr[1]:.1f} ms, depth {reduce_depth(nb)} adds, "
          f"serial sweep {2 * (nb - 1)})")
    results["msm_accumulate"] = dict(
        max_abs_err=err_a, plain_ms=ta[1], **ta[0], plan_ms=plan_ms,
        plan_device_ms=plan_dev_ms,
        shape=f"{n} points, c={c}, {rows} rows x {nb} buckets, {adds} mixed "
              f"adds, max row load {stats['max_row_load']} (max bucket load "
              f"{stats['max_load']})",
        bound=acc_bound)
    results["msm_reduce"] = dict(
        max_abs_err=err_r, plain_ms=tr[1], **tr[0],
        shape=f"{rows} rows x {nb} buckets",
        bound=bound(lanes * 96 + rows * 96,
                    rows * 2 * (nb - 1) * FULL_ADD_MULS * MONT_MUL_IMAD))


def check_padd(dev, rng, params, bound, results):
    """The batched complete add on special pairs, then as a tree of adds
    over the K=16 SRS's digit points (the first level, 2^20 pairs, against
    the twin and timed), whose normalised sum must be phase 3's SRS word
    for word. Returns (scalars, table, normalised tree sum, the
    tree's device ms and events ms) for the fixed-base check."""
    from halo2_snark_aggregator_tpu_torch import device as dv
    from halo2_snark_aggregator_tpu_torch.ff import bn254 as ff
    from halo2_snark_aggregator_tpu_torch.ops import curve as cv
    from halo2_snark_aggregator_tpu_torch.ops import field as fo
    from halo2_snark_aggregator_tpu_torch.prover import srs

    m = PADD_PAIRS
    a = params.g_dev[:m].clone()
    b = params.g_dev[m : 2 * m].clone()
    ident = torch.stack([torch.zeros(8, dtype=torch.int32, device=dev),
                         fo.const(fo.FQ, 1, dev)[0],
                         torch.zeros(8, dtype=torch.int32, device=dev)])
    b[0] = ident                  # P + O
    a[1] = ident                  # O + Q
    a[2] = ident                  # O + O
    b[2] = ident
    b[3] = a[3]                   # P + P
    b[4] = a[4]                   # P + (-P)
    b[4, 1] = fo.elementwise(fo.SUB, fo.FQ, torch.zeros_like(a[4, 1]), a[4, 1])
    out_k = cv.padd(a, b)
    out_p = cv.padd_plain(a, b)
    err = max_abs_err(out_k, out_p)
    twice_k = cv.padd(out_k, out_k)    # projective inputs, z != 1
    err = max(err, max_abs_err(twice_k, cv.padd_plain(out_k, out_k)))
    if err:
        raise AssertionError(f"padd kernel differs from its twin: {err}")
    ha = cv.to_affine_ints(a[:8].unbind(1))
    hb = cv.to_affine_ints(b[:8].unbind(1))
    if cv.to_affine_ints(out_k[:8].unbind(1)) != [ff.g1_add(p, q)
                                                  for p, q in zip(ha, hb)]:
        raise AssertionError("padd special cases differ from the host add")
    # the tree of adds over the K=16 SRS's digit points that setup ran
    # before the fixed-base kernel: its first level (2^20 pairs) against the
    # twin and timed, its normalised sum against phase 3's SRS
    n = params.n
    sw = srs.tau_powers_words(NTT_K, dev)
    if not torch.equal(sw, fo.to_tensor(fo.ints_to_words(srs.tau_powers(NTT_K)),
                                         dev)):
        raise AssertionError("tau powers built on the card differ from the "
                             "host list")
    table = srs.g1_table(dev)
    pts = cv.digit_points(sw, table)
    half = pts.shape[0] // 2
    lo = pts[:half].reshape(-1, 3, 8)
    hi = pts[half:].reshape(-1, 3, 8)
    out_p, plain_ms = once_ms(lambda: torch.cat([
        cv.padd_plain(lo[i : i + PLAIN_CHUNK], hi[i : i + PLAIN_CHUNK])
        for i in range(0, lo.shape[0], PLAIN_CHUNK)]))
    err = max(err, max_abs_err(cv.padd(lo, hi), out_p))
    if err:
        raise AssertionError(f"padd kernel differs from its twin: {err}")
    t = dict(timed(lambda: cv.padd(lo, hi), "padd_kernel", 10), plain_ms=plain_ms)
    m = lo.shape[0]
    tree = cv.normalize_affine(cv.padd_tree(pts))
    if not torch.equal(tree, params.g_dev):
        raise AssertionError("the SRS made by the fixed-base kernel differs "
                             "from the padd tree's table")

    def run_tree():
        return cv.padd_tree(cv.digit_points(sw, table))

    tree_ms = dv.profile_device(run_tree, dev)["device_busy_s"] * 1e3
    tree_launch_ms = cuda_ms(run_tree, 3)
    phase("4d padd", f"exact over {PADD_PAIRS} pairs (identity either side and "
          f"both, P + P, P + (-P), projective inputs) and the first level of "
          f"the tree of adds over the K={NTT_K} SRS's digit points ({m} "
          f"pairs; the tau powers built on the card == the host list), whose "
          f"normalised sum == phase 3's SRS word for word; "
          f"first level "
          f"{t['ms']:.4f} ms device, {t['launch_ms']:.4f} ms launch (plain "
          f"{t['plain_ms']:.1f} ms); the whole tree with its gather "
          f"{tree_ms:.4f} ms device, {tree_launch_ms:.4f} ms events")
    results["curve_padd"] = dict(max_abs_err=err, **t,
                                 shape=f"{m} pairs (the first of 5 levels of "
                                       f"a tree over 2^{NTT_K} scalars' digit "
                                       f"points)",
                                 bound=bound(m * 288, m * FULL_ADD_MULS * MONT_MUL_IMAD))
    return sw, table, tree, (tree_ms, tree_launch_ms)


def check_fixed_base(dev, sw, table, srs_affine, tree_times, bound, results,
                     tag="4d fixed_base", twin_rows=None):
    """The fixed-base kernel over a setup's tau powers against its twin (on
    the card) word for word (over the first `twin_rows` scalars, default
    all: each scalar's sum is its own), its normalised sum against
    `srs_affine` (the padd tree's at K=16, the setup's SRS at K=18 and
    k=22); on special scalars against the twin; timed, at K=16 beside the
    tree (`tree_times`, else None)."""
    from halo2_snark_aggregator_tpu_torch.ff import bn254 as ff
    from halo2_snark_aggregator_tpu_torch.ops import curve as cv
    from halo2_snark_aggregator_tpu_torch.ops import field as fo

    n = sw.shape[0]
    m = n if twin_rows is None else twin_rows
    got = cv.fixed_base(sw, table)
    want, plain_ms = once_ms(lambda: cv.fixed_base_plain(sw[:m], table))
    err = max_abs_err(got[:m], want)
    if not torch.equal(cv.normalize_affine(got), srs_affine):
        raise AssertionError("fixed-base sums differ from the SRS")
    special = fo.to_tensor(fo.ints_to_words(
        [0, 1, ff.R - 1, (0x01 << 248) | (0x0203 << 120) | 0x04,
         (1 << 256) - 1]), dev)
    err = max(err, max_abs_err(cv.fixed_base(special, table),
                               cv.fixed_base_plain(special, table)))
    if err:
        raise AssertionError(f"fixed-base kernel differs from its twin: {err}")
    t = timed(lambda: cv.fixed_base(sw, table), "fixed_base_kernel", 10)
    # the work this run's scalars need: one mixed add for each nonzero digit
    # past a scalar's first
    shifts = torch.arange(0, 32, cv.WINDOW, device=dev)
    nonzero = ((((sw.long() & 0xFFFFFFFF)[..., None] >> shifts) & 0xFF) != 0
               ).reshape(n, -1).sum(1)
    adds = int((nonzero - 1).clamp(min=0).sum().item())
    k = n.bit_length() - 1
    tree = ""
    extra = {}
    if tree_times is not None:
        tree_ms, tree_launch_ms = tree_times
        tree = (f"; the padd tree with its gather {tree_ms:.4f} ms device, "
                f"{tree_launch_ms:.4f} ms events")
        extra = dict(tree_ms=tree_ms, tree_launch_ms=tree_launch_ms)
    phase(tag, f"exact against its twin over {m} of the {n} K={k} tau "
          f"powers (normalised == the SRS) and on 5 special scalars (0, 1, r - 1, "
          f"zero digits inside, all digits 0xff); {adds} mixed adds; one "
          f"launch {t['ms']:.4f} ms device, {t['launch_ms']:.4f} ms events "
          f"(plain {plain_ms:.1f} ms over {m}){tree}")
    results["fixed_base"] = dict(
        max_abs_err=err, plain_ms=plain_ms, plain_rows=m, **t, **extra,
        shape=f"{n} scalars (the K={k} SRS's tau powers), {adds} mixed adds",
        bound=bound(n * 32 + table.numel() * 4 + n * 96,
                    adds * MIXED_ADD_MULS * MONT_MUL_IMAD))


def check_ntt(dev, rng, bound, results, batch: int, k: int = NTT_K,
              twin_cols=None, tag="4e ntt", check_plan=True):
    """The transform kernel at 2^k points: the plan built on the card equals
    the host plan word for word (twiddles and bit reversal, both
    directions); one vector, forward and inverse, and a batch of `batch`
    columns forward with a coset factor (the quotient shard's extension)
    and inverse, each against its twin word for word (the batch twin on
    `twin_cols`, by default every column, 8 at a time); forward == native
    fr_ntt;
    inverse(forward) == input. An inverse makes one launch a pass and no
    other (its last pass applies 1/n). `check_plan=False` skips the plan
    check where an earlier phase held the plan at this k. Timed: each forward and inverse, the
    batch's forward also without the coset factor; the inverse's device
    time less that forward's reads the 1/n epilogue together with whatever
    the pass's stalls hide of it."""
    from halo2_snark_aggregator_tpu_torch import native
    from halo2_snark_aggregator_tpu_torch.kernels import build
    from halo2_snark_aggregator_tpu_torch.ops import field as fo
    from halo2_snark_aggregator_tpu_torch.ops import ntt as pn
    from halo2_snark_aggregator_tpu_torch.prover.domain import omega_for_k

    n = 1 << k
    for inverse in (False, True) if check_plan else ():
        rev, tw, _n_inv = pn.device_plan(k, inverse, dev)
        h_rev, h_tw, _ = pn._plan(k, inverse)
        if not (np.array_equal(rev.cpu().numpy(), h_rev)
                and np.array_equal(fo.to_numpy(tw), h_tw)):
            raise AssertionError(f"the NTT plan built on the card differs from "
                                 f"the host plan at k={k}, inverse={inverse}")
    cols = list(range(batch)) if twin_cols is None else list(twin_cols)
    chunks = [torch.tensor(cols[i : i + 8], device=dev)
              for i in range(0, len(cols), 8)]
    vals = rand_ints(fo.FR.modulus, n, rng)
    x = fo.mont_words(fo.FR, vals, dev)[None]
    xb = rand_fr_bulk((batch, n), rng, dev)
    coset = rand_fr_bulk((n,), rng, dev)
    errs = []
    for inverse in (False, True):
        errs.append(max_abs_err(pn.ntt_batch(x, k, inverse),
                                pn.ntt_batch_plain(x, k, inverse)))
    got = pn.ntt_batch(xb, k, coset=coset)
    want, batch_plain_ms = once_ms(lambda: torch.cat([
        pn.ntt_batch_plain(xb[c], k, coset=coset) for c in chunks]))
    errs.append(max_abs_err(got[cols], want))
    del got, want
    before = dict(build.LAUNCHES)
    got = pn.ntt_batch(xb, k, inverse=True)
    inv_launches = {kn: c - before[kn] for kn, c in build.LAUNCHES.items()
                    if c != before[kn]}
    passes = len(pn.pass_bounds(k))
    if inv_launches != {"ntt_transform": passes}:
        raise AssertionError(f"an inverse at k={k} launched {inv_launches}, "
                             f"want {passes} transform passes and nothing else")
    want, inv_plain_ms = once_ms(lambda: torch.cat([
        pn.ntt_batch_plain(xb[c], k, inverse=True) for c in chunks]))
    errs.append(max_abs_err(got[cols], want))
    del got, want
    fwd = pn.ntt_auto(x[0], k)
    if fo.from_mont_words(fo.FR, fwd) != native.fr_ntt(vals, omega_for_k(k)):
        raise AssertionError("forward NTT differs from the native fr_ntt")
    if not torch.equal(pn.ntt_auto(fwd, k, inverse=True), x[0]):
        raise AssertionError("inverse(forward(x)) != x")
    err = max(errs)
    if err:
        raise AssertionError(f"ntt kernel differs from its twin: {err}")

    def both(fn, reps):
        return dict(ms=kernel_ms(fn, "ntt_pass_kernel", reps, passes),
                    launch_ms=cuda_ms(fn, reps))

    t1 = both(lambda: pn.ntt_batch(x, k), 10)
    t1i = both(lambda: pn.ntt_batch(x, k, inverse=True), 10)
    tb = both(lambda: pn.ntt_batch(xb, k, coset=coset), 5)
    tbf = both(lambda: pn.ntt_batch(xb, k), 5)
    tbi = both(lambda: pn.ntt_batch(xb, k, inverse=True), 5)
    _out, t1_plain = once_ms(lambda: pn.ntt_batch_plain(x, k))
    _rev, _tw, n_inv = pn.device_plan(k, True, dev)
    _out, scale_plain_ms = once_ms(lambda: pn.scale_plain(xb[cols], n_inv))
    scale_ms = tbi["ms"] - tbf["ms"]
    plan = ("the plan built on the card == the host plan" if check_plan
            else "the plan as held in phase 10")
    phase(tag, f"k={k}: {plan}; the "
          f"transform ({passes} launches, passes "
          f"{pn.pass_bounds(k)}) exact against its twin at b=1 forward and "
          f"inverse and at b={batch} forward with a coset factor and inverse "
          f"(the twin on {len(cols)} of the columns); "
          f"forward == native fr_ntt, inverse(forward) == input; an inverse "
          f"launched {inv_launches}; device ms (events ms): b=1 forward "
          f"{t1['ms']:.4f} ({t1['launch_ms']:.4f}), inverse {t1i['ms']:.4f} "
          f"({t1i['launch_ms']:.4f}) (plain {t1_plain:.1f} ms); b={batch} "
          f"forward with the coset {tb['ms']:.4f} ({tb['ms'] / batch:.4f} a "
          f"column; {tb['launch_ms']:.4f}), without {tbf['ms']:.4f} "
          f"({tbf['launch_ms']:.4f}), inverse {tbi['ms']:.4f} "
          f"({tbi['launch_ms']:.4f}) (plain over {len(cols)} columns, 8 a call, "
          f"{batch_plain_ms:.1f} / {inv_plain_ms:.1f} ms); inverse less "
          f"forward (the 1/n epilogue of the last pass, not separable from "
          f"the pass): {scale_ms:.4f} ms for {batch} columns, "
          f"{t1i['ms'] - t1['ms']:.4f} ms for one (plain scale over "
          f"{len(cols)} columns {scale_plain_ms:.2f} ms)")
    tw_bytes = (n - 1) * 32
    results["ntt_transform"] = dict(
        max_abs_err=err, plain_ms=batch_plain_ms, **tb,
        plain_columns=len(cols),
        shape=f"{batch} columns of n=2^{k} with a coset factor (a quotient "
              f"shard's extension), {passes} launches",
        bound=bound(batch * n * 64 + tw_bytes + n * 32,
                    batch * (n // 2 * k + n) * MONT_MUL_IMAD),
        b1_ms=t1["ms"], b1_launch_ms=t1["launch_ms"], b1_plain_ms=t1_plain,
        b1_bound_ms=bound(n * 64 + tw_bytes, n // 2 * k * MONT_MUL_IMAD)[0],
        b1_inverse_ms=t1i["ms"], b1_inverse_launch_ms=t1i["launch_ms"],
        forward_ms=tbf["ms"], inverse_ms=tbi["ms"],
        inverse_launch_ms=tbi["launch_ms"],
        inverse_plain_ms=inv_plain_ms,
        inverse_launches=inv_launches["ntt_transform"],
        scale_replaces="halo2_snark_aggregator_tpu/ops/ntt_pallas.py:179",
        scale_ms=scale_ms, scale_plain_ms=scale_plain_ms,
        scale_bound_ms=bound(0, batch * n * MONT_MUL_IMAD)[0])


def program_slice(prog, cols, start: int, m: int):
    """Rows [start, start + m) of `prog` over `cols` as a program of their
    own: each column reference (c, rot) becomes a column of m rows read at
    rotation 0, cols[c][(start + rot + i) mod n], so the twin over m rows
    gives those rows of the full run."""
    from halo2_snark_aggregator_tpu_torch.ops import field as fo

    n = cols[0].shape[0]
    rows = start + torch.arange(m, device=cols[0].device)
    sliced = [cols[c][(rows + rot) % n].contiguous()
              for c, rot in prog.refs.tolist()]
    refs = np.stack([np.arange(len(sliced)), np.zeros(len(sliced), np.int64)], 1)
    return fo.RowProgram(prog.code, refs, prog.consts, len(sliced), prog.out), sliced


def check_program(dev, rng, vk, bound, results, slice_rows=None,
                  tag="4f program"):
    """The row-program kernel on the key's zkevm-shape quotient program
    (one proof, random challenges) over random extended columns, against
    its twin on the card, word for word: over all 2^k rows, or with
    `slice_rows` m over m rows from a random start (`program_slice`)."""
    from halo2_snark_aggregator_tpu_torch.ff import bn254 as ff
    from halo2_snark_aggregator_tpu_torch.ops import field as fo
    from halo2_snark_aggregator_tpu_torch.prover import quotient_program as qp

    k = vk.k
    n = 1 << k
    cs = vk.cs
    ch = rand_ints(ff.R, cs.num_challenges + 4, rng)
    prog, keys = qp.compile_quotient(cs, 1, ch[4:], *ch[:4])
    cols = list(rand_fr_bulk((len(keys), n), rng, dev).unbind(0))
    got = fo.run_program(prog, cols)
    if slice_rows is None:
        start, m = 0, n
        want, plain_ms = once_ms(lambda: fo.run_program_plain(prog, cols))
    else:
        start, m = int(rng.integers(n)), slice_rows
        sprog, scols = program_slice(prog, cols, start, m)
        want, plain_ms = once_ms(lambda: fo.run_program_plain(sprog, scols))
        got = torch.roll(got, -start, dims=0)[:m]
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"row-program kernel differs from its twin: {err}")
    t = timed(lambda: fo.run_program(prog, cols), "field_program_kernel", 10)
    smem = len(prog.code) * 16 + len(prog.refs) * 8 + len(prog.consts) * 32
    phase(tag, f"K={k} quotient program ({len(prog.code)} "
          f"instructions, {prog.products} products, {prog.n_slots} slots of "
          f"{fo.PROGRAM_SLOTS}, {len(keys)} columns, {len(prog.refs)} column "
          f"references, {len(prog.consts)} constants, {smem} B of shared "
          f"memory) exact against its twin over {m} of the 2^{k} rows (from "
          f"row {start}); {t['ms']:.4f} ms device, {t['launch_ms']:.4f} ms "
          f"launch (plain {plain_ms:.1f} ms over {m} rows)")
    results["field_program"] = dict(
        max_abs_err=err, plain_ms=plain_ms, plain_rows=m, **t,
        shape=f"K={k} quotient shard: {len(prog.code)} instructions, "
              f"{prog.products} products, {len(keys)} columns x 2^{k} rows",
        bound=bound((len(keys) + 1) * n * 32,
                    prog.products * n * MONT_MUL_IMAD),
        instructions=len(prog.code), products=prog.products,
        slots=prog.n_slots, columns=len(keys), smem_bytes=smem)


def check_elementwise(dev, rng, n: int, bound, results, tag: str,
                      twin_rows=None):
    """The field kernel's mul, add and sub on (n, 8) Fr polynomials against
    its twin on the card, word for word (over the first `twin_rows` rows,
    default all: each row is its own); the mul timed."""
    from halo2_snark_aggregator_tpu_torch.ops import field as fo

    m = n if twin_rows is None else twin_rows
    pa, pb = rand_fr_bulk((2, n), rng, dev).unbind(0)
    errs = []
    for mode in (fo.MUL, fo.ADD, fo.SUB):
        out_p = torch.empty((m, 1, 8), dtype=torch.int32, device=dev)
        fo.field_op_plain(mode, fo.FR, m, pa[:m].reshape(m, 1, 8),
                          pb[:m].reshape(m, 1, 8), None, None, False, out_p,
                          None, None)
        errs.append(max_abs_err(fo.elementwise(mode, fo.FR, pa, pb)[:m],
                                out_p.reshape(m, 8)))
    err = max(errs)
    if err:
        raise AssertionError(f"field kernel differs from its twin: {err}")

    def run_p():
        out = torch.empty((m, 1, 8), dtype=torch.int32, device=dev)
        fo.field_op_plain(fo.MUL, fo.FR, m, pa[:m].reshape(m, 1, 8),
                          pb[:m].reshape(m, 1, 8), None, None, False, out, None,
                          None)

    t = timed(lambda: fo.elementwise(fo.MUL, fo.FR, pa, pb), "field_kernel", 20)
    plain_ms = cuda_ms(run_p, 3)
    phase(tag, f"mul/add/sub over {n} x 8 words exact against the twin (on "
          f"{m} rows); mul {t['ms']:.4f} ms device, {t['launch_ms']:.4f} ms "
          f"launch (plain {plain_ms:.2f} ms over {m} rows)")
    results["field"] = dict(max_abs_err=err, plain_ms=plain_ms, plain_rows=m, **t,
                            shape=f"mul {n} x 8 words (the prover's elementwise)",
                            bound=bound(n * 96, n * MONT_MUL_IMAD))


def native_msm_words(table, scalars_std: torch.Tensor):
    """The native host Pippenger over an affine table and standard-form
    scalars, handed to it as bytes straight from the words (no Python
    ints): the oracle of a device commit at 2^22 points."""
    from halo2_snark_aggregator_tpu_torch import native
    from halo2_snark_aggregator_tpu_torch.ops import field as fo

    tx, ty, ident = table
    one = fo.const(fo.FQ, 1, tx.device, mont=False)
    xs, ys = (fo.to_numpy(fo.elementwise(fo.MUL, fo.FQ, c, one.expand_as(c)))
              .tobytes() for c in (tx, ty))
    inf = ident.to(torch.uint8).cpu().numpy().tobytes()
    sc = fo.to_numpy(scalars_std).tobytes()
    lib = native._get()
    out, outp = native._outbuf(64)
    oinf, oinfp = native._outbuf(1)
    lib.h2t_g1_msm(native._buf(xs), native._buf(ys), native._buf(inf),
                   native._buf(sc), tx.shape[0], outp, oinfp)
    if oinf.raw[0]:
        return None
    return (int.from_bytes(out.raw[:32], "little"),
            int.from_bytes(out.raw[32:], "little"))


def k18_phase(dev, rng, bound, paths, read_path, results) -> None:
    """Phase 9: the K=18 131-column workload through the card. The SRS and
    key (fingerprint checked), proof 0 byte-equal to the fixture with the
    stage split and the peak device bytes of each stage, the working set
    and the spill decision; every kernel at its K=18 shape against its
    twin; the batched verifier: batch 2 == the value oracle, batch 128
    (the bench's) passes, a flipped byte fails."""
    from halo2_snark_aggregator_tpu_torch import fixtures
    from halo2_snark_aggregator_tpu_torch import prove as pprove
    from halo2_snark_aggregator_tpu_torch.arith.device_value import make_device_chips
    from halo2_snark_aggregator_tpu_torch.bench import tiled_proofs
    from halo2_snark_aggregator_tpu_torch.kernels import build
    from halo2_snark_aggregator_tpu_torch.ops import field as fo
    from halo2_snark_aggregator_tpu_torch.protocol.batched import BatchedVerifier
    from halo2_snark_aggregator_tpu_torch.prover import quotient_program, srs

    k = 18
    wl = fixtures.workload(k)
    gib = 1 << 30
    t_phase = time.perf_counter()
    build.reset_launches()
    params, vk, apk, timings = fixtures.setup(k, dev, "device")
    read_path("setup_keygen_k18")
    if paths["setup_keygen_k18"]["fixed_base"] != 1:
        raise AssertionError("the K=18 SRS took more than one fixed-base launch")
    phase("9a K=18 setup+keygen", f"SRS 2^{k} and the {vk.cs.num_advice_columns}"
          f"-advice-column zkevm-shape key (n_groups {wl.n_groups}) on the "
          f"card, vk fingerprint {wl.fingerprint}; setup {timings['setup_s']:.1f} "
          f"s (peak {timings['setup_peak_bytes'] / gib:.2f} GiB), keygen "
          f"{timings['keygen_s']:.1f} s (peak "
          f"{timings['keygen_peak_bytes'] / gib:.2f} GiB); launches "
          f"{paths['setup_keygen_k18']}")
    run = pprove.timed_proof(params, apk, 0)  # resets the counts first
    read_path("prove_k18")
    want = wl.load_proofs()
    if run["proof"] != want[0][0]:
        raise AssertionError("the K=18 proof made on the card differs from "
                             f"zkevm_proof_k18_{wl.fingerprint}_0.json")
    ws = pprove.working_set(vk, max(timings["setup_peak_bytes"],
                                    timings["keygen_peak_bytes"],
                                    run["peak_bytes"]))
    split = " ".join(f"{s}={v:.2f}s/{run['stages_peak_bytes'][s] / gib:.2f}GiB"
                     for s, v in run["stages_s"].items())
    phase("9b K=18 prove", f"proof 0 with device commits == committed bytes "
          f"({len(run['proof'])} B); {run['seconds']:.2f} s; stages (seconds/"
          f"peak) {split}; {run['commits']} commits, slowest "
          f"{run['commit_s_max']:.3f} s, max bucket load "
          f"{run['max_bucket_load']}, max row load {run['max_row_load']}; "
          f"commit split (s, summed) "
          f"{ {s: round(v, 3) for s, v in run['commit_split_s'].items()} }; "
          f"launches {paths['prove_k18']}; working set: peak "
          f"{ws['peak_bytes'] / gib:.2f} GiB over {ws['quotient_columns']} "
          f"quotient columns, k=22 aggregator estimate "
          f"{ws['agg_k22_estimate_bytes'] / gib:.2f} GiB, limit "
          f"{ws['limit_bytes'] / 1e9:.0f} GB: spill "
          f"{'needed' if ws['spill_needed'] else 'not needed'}")
    results["prove"] = dict(
        seconds=run["seconds"], stages_s=run["stages_s"],
        stages_peak_bytes=run["stages_peak_bytes"], setup=timings,
        working_set=ws, launches=run["launches"],
        commit_split_s=run["commit_split_s"])

    kernels = results.setdefault("kernels", {})
    sw = srs.tau_powers_words(k, dev)
    if not torch.equal(sw, fo.to_tensor(fo.ints_to_words(srs.tau_powers(k)), dev)):
        raise AssertionError("tau powers built on the card differ from the "
                             "host list at K=18")
    check_fixed_base(dev, sw, srs.g1_table(dev), params.g_dev, None, bound,
                     kernels, tag="9c fixed_base")
    check_elementwise(dev, rng, 1 << k, bound, kernels, tag="9c field")
    ext_cols = len(quotient_program.compile_quotient(
        vk.cs, 1, [0] * vk.cs.num_challenges, 0, 0, 0, 0)[1])
    check_ntt(dev, rng, bound, kernels, ext_cols, k=k,
              twin_cols=(0, ext_cols // 2, ext_cols - 1), tag="9d ntt")
    torch.cuda.empty_cache()
    check_program(dev, rng, vk, bound, kernels, slice_rows=1 << 12,
                  tag="9e program")
    torch.cuda.empty_cache()
    check_msm(dev, rng, params, bound, kernels, tag="9f msm")

    proofs, insts = tiled_proofs(k)
    t0 = time.perf_counter()
    oracle = value_oracle(params, vk, proofs[:2], insts[:2])
    oracle_s = time.perf_counter() - t0
    # the hybrid chips at their default crossover: two K=18 proofs make an
    # MSM above DEVICE_MIN, which goes to the card
    chips = make_device_chips(dev)
    build.reset_launches()
    t0 = time.perf_counter()
    hybrid = value_oracle(params, vk, proofs[:2], insts[:2], chips)
    hybrid_s = time.perf_counter() - t0
    read_path("hybrid_k18")
    ctx, pchip = chips[0], chips[3]
    if hybrid != oracle or not pchip.device_msms:
        raise AssertionError(f"K=18 hybrid chips: pair == value oracle "
                             f"{hybrid == oracle}, {pchip.device_msms} MSMs on "
                             f"the card")
    phase("9h K=18 hybrid", f"make_device_chips (device_min "
          f"{pchip.device_min}) over 2 K=18 proofs: pair == value oracle; "
          f"{pchip.device_msms} of {len(ctx.msm_sizes)} multi_exps on the card "
          f"(sizes {ctx.msm_sizes}); {hybrid_s:.3f} s against the value "
          f"chips' {oracle_s:.3f} s")
    bv2 = BatchedVerifier(vk, params, batch=2, sample_proof=proofs[0],
                          sample_instances=insts[0], device=dev)
    w_x, w_g, ok = bv2.verify(proofs[:2], insts[:2])
    if not ok or (w_x, w_g) != oracle:
        raise AssertionError(f"K=18 batch-2 parity failed: ok={ok}, "
                             f"match={(w_x, w_g) == oracle}")
    t0 = time.perf_counter()
    bv = BatchedVerifier(vk, params, batch=len(proofs), sample_proof=proofs[0],
                         sample_instances=insts[0], device=dev)
    record_s = time.perf_counter() - t0
    build.reset_launches()
    *_pair, ok = bv.verify(proofs, insts)  # warm
    if not ok:
        raise AssertionError("K=18 batch-128 warm verify failed")
    t0 = time.perf_counter()
    for _ in range(REPS):
        *_pair, ok = bv.verify(proofs, insts)
        if not ok:
            raise AssertionError("K=18 batch-128 timed verify failed")
    dt = (time.perf_counter() - t0) / REPS
    read_path("verify_k18")
    off = next(ref for kind, ref in bv.manifest if kind == "scalar")
    bad = list(proofs)
    corrupt = bytearray(bad[5])
    corrupt[off] ^= 0x01
    bad[5] = bytes(corrupt)
    try:
        *_pair, ok = bv.verify(bad, insts)
    except ValueError:
        ok = False
    if ok:
        raise AssertionError("K=18: a corrupted proof was accepted")
    check_poseidon(dev, rng, bv, bound, kernels, tag="9g poseidon",
                   twin_lanes=8)
    phase("9h K=18 verify", f"batch 2 (w_x, w_g) == value oracle (oracle "
          f"{oracle_s:.1f} s); batch {bv.batch}: {bv.batch / dt:.2f} proofs/s "
          f"({dt:.3f} s/verify), record {record_s:.1f} s, "
          f"{len(bv.tape.records)} tape records, "
          f"{sum(len(e) for e, _ in bv.msm_plans)} MSM entries/lane, "
          f"{bv.run_tape.sponge.n_in.shape[0]} sponge calls a lane; launches "
          f"over {REPS + 1} verifies {paths['verify_k18']}; "
          f"flipped scalar byte of proof 5 fails; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    results["hybrid"] = dict(device_min=pchip.device_min,
                             device_msms=pchip.device_msms,
                             msm_sizes=ctx.msm_sizes, seconds=hybrid_s,
                             value_seconds=oracle_s)
    results["verify"] = dict(proofs_per_s=bv.batch / dt, batch=bv.batch,
                             tape_records=len(bv.tape.records),
                             msm_entries_per_lane=sum(len(e) for e, _ in bv.msm_plans),
                             stages_s=bv.last_profile)


def graphed_accumulate_plain(tx, ty, order, starts, counts, weights):
    """`ops/msm.accumulate_plain` with its steps captured once as a CUDA
    graph and replayed once a step: the same mixed adds in the same order,
    each step over every lane, a lane past its count keeping its sum. The
    eager twin launches ~1,400 small ops a step (~19 ms a step on one H100
    80GB HBM3 at 700 W, PERF.md), and a lane of the 2^22 plan holds 8,192
    points. (lanes, 3, 8) words."""
    from halo2_snark_aggregator_tpu_torch.ops import curve as cv
    from halo2_snark_aggregator_tpu_torch.ops import field as fo

    dev = tx.device
    lanes = counts.numel()
    cnt = counts.reshape(-1).long()
    base = (weights.long()[:, None] * order.shape[1] + starts.long()).reshape(-1)
    flat = order.reshape(-1)
    init = [torch.zeros(lanes, fo.WORDS, dtype=torch.int32, device=dev),
            fo.const(fo.FQ, 1, dev).expand(lanes, fo.WORDS).clone(),
            torch.zeros(lanes, fo.WORDS, dtype=torch.int32, device=dev)]
    acc = [c.clone() for c in init]
    t = torch.zeros((), dtype=torch.int64, device=dev)

    def step():
        live = cnt > t
        idx = flat[torch.where(live, base + t, 0)].long()
        new = cv.mixed_add(tuple(acc), tx[idx], ty[idx])
        for c, v in zip(acc, new):
            c.copy_(torch.where(live[:, None], v, c))
        t.add_(1)

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        step()                  # warm: the field constants, the allocator
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    for c, c0 in zip(acc, init):
        c.copy_(c0)
    t.zero_()
    for _ in range(int(cnt.max()) if lanes else 0):
        graph.replay()
    return torch.stack(acc, dim=1)


def check_msm_k22(dev, table, std, want, bound, results):
    """The accumulate and reduce kernels on the plan of phase 10's 2^22
    commit (its scalars, the SRS table, c = 8). The kernels run over the
    whole plan; their twins on the card over its row with the most adds,
    its first and its last (two rows when those coincide), each word
    equal; the row
    combine equals the native Pippenger's total `want`. The graphed twin
    is first held against the eager twin on those rows cut to 16 points a
    lane. Both kernels timed with torch.profiler."""
    from halo2_snark_aggregator_tpu_torch.ops import msm as pm

    c = 8
    tx, ty, ident = table
    stats = {}
    plan = pm.bucket_plan_split(std.masked_fill(ident[:, None], 0), c,
                                stats=stats)
    order, starts, counts, weights = plan
    rows, nb = counts.shape
    acc_k = pm.accumulate(tx, ty, *plan)
    tot_k = pm.reduce(acc_k, rows, nb)
    if pm.combine_rows_host(tot_k.unbind(1), weights, c) != want:
        raise AssertionError("the 2^22 kernels' total differs from the native "
                             "Pippenger")
    sel = sorted({int(counts.sum(dim=1).argmax()), 0, rows - 1})
    sub = (starts[sel].contiguous(), counts[sel].contiguous(),
           weights[sel].contiguous())
    short = (sub[0], sub[1].clamp(max=16), sub[2])
    if not torch.equal(graphed_accumulate_plain(tx, ty, order, *short),
                       pm.accumulate_plain(tx, ty, order, *short)):
        raise AssertionError("the graphed accumulate twin differs from the "
                             "eager twin")
    acc_p, acc_plain_ms = once_ms(
        lambda: graphed_accumulate_plain(tx, ty, order, *sub))
    acc_sel = acc_k.view(rows, nb, 3, -1)[sel].reshape(-1, 3, acc_k.shape[-1])
    err_a = max_abs_err(acc_sel, acc_p)
    tot_p, red_plain_ms = once_ms(lambda: pm.reduce_plain(acc_sel, len(sel), nb))
    err_r = max_abs_err(tot_k[sel], tot_p)
    if err_a or err_r:
        raise AssertionError(f"2^22 msm kernels differ from their twins: "
                             f"{err_a}, {err_r}")
    ta = timed(lambda: pm.accumulate(tx, ty, *plan), "accumulate_kernel", 3)
    tr = timed(lambda: pm.reduce(acc_k, rows, nb), "reduce_kernel", 5)
    n, adds, lanes = std.shape[0], stats["adds"], rows * nb
    acc_bound = bound(n * 64 + order.numel() * 4 + lanes * 8 + rows * 4
                      + lanes * 96, adds * MIXED_ADD_MULS * MONT_MUL_IMAD)
    red_bound = bound(lanes * 96 + rows * 96,
                      rows * 2 * (nb - 1) * FULL_ADD_MULS * MONT_MUL_IMAD)
    depth = int(sub[1].max())
    phase("10 msm", f"the 2^22 commit's plan ({rows} rows, {adds} adds, max "
          f"row load {stats['max_row_load']}): the kernels' total == native "
          f"Pippenger; rows {sel} ({len(sel) * nb} lanes, {depth} steps) word "
          f"for word against the twins on the card (the graphed twin == the "
          f"eager one on them cut to 16 points); accumulate {ta['ms']:.3f} ms "
          f"device (twin {acc_plain_ms:.0f} ms over {len(sel)} rows, bound "
          f"{acc_bound[0]:.3f} ms, {acc_bound[1]}); reduce {tr['ms']:.4f} ms "
          f"device (twin {red_plain_ms:.1f} ms over {len(sel)} rows, bound "
          f"{red_bound[0]:.4f} ms)")
    results["msm_accumulate"] = dict(
        max_abs_err=err_a, plain_ms=acc_plain_ms, plain_rows=len(sel), **ta,
        shape=f"{n} points, c={c}, {rows} rows x {nb} buckets, {adds} mixed "
              f"adds, max row load {stats['max_row_load']}; twin (graphed) "
              f"over rows {sel}, {depth} steps",
        bound=acc_bound)
    results["msm_reduce"] = dict(
        max_abs_err=err_r, plain_ms=red_plain_ms, plain_rows=len(sel), **tr,
        shape=f"{rows} rows x {nb} buckets; twin over rows {sel}",
        bound=red_bound)


def k22_commit(dev, rng, bound, read_path, results):
    """Phase 10: the k=22 SRS (the aggregator's size) built on the card and
    cached (temp file, os.replace) then loaded, a few rows against the host
    g1_mul, the fixed-base kernel at its 2^22 tau powers against its twin
    (on a slice); one device commit of 2^22 random scalars against the
    native host Pippenger, its split by phase and its largest row load, and
    the MSM kernels on its plan against their twins (`check_msm_k22`); the
    2^22 transform (three passes) and its plan against their twins. Returns
    the SRS, which phase 11 proves with."""
    import tempfile

    from halo2_snark_aggregator_tpu_torch import device as dv
    from halo2_snark_aggregator_tpu_torch.ff import bn254 as ff
    from halo2_snark_aggregator_tpu_torch.kernels import build
    from halo2_snark_aggregator_tpu_torch.ops import curve as cv
    from halo2_snark_aggregator_tpu_torch.ops import field as fo
    from halo2_snark_aggregator_tpu_torch.ops import ntt as pn
    from halo2_snark_aggregator_tpu_torch.prover import srs

    k = AGG_K
    gib = 1 << 30
    with tempfile.TemporaryDirectory() as tmp:
        dv.reset_peak(dev)
        build.reset_launches()
        t0 = time.perf_counter()
        params = srs.setup_cached_accel(k, cache_dir=tmp, device=dev)
        dv.synchronize(dev)
        setup_s = time.perf_counter() - t0
        read_path("setup_k22")
        setup_peak = dv.peak_bytes(dev)
        t0 = time.perf_counter()
        again = srs.setup_cached_accel(k, cache_dir=tmp, device=dev)
        load_s = time.perf_counter() - t0
        if not torch.equal(again.g_dev, params.g_dev):
            raise AssertionError("the k=22 SRS loaded from the cache differs")
        del again
    tau = srs._tau_for(k, srs.SEED)
    rows = sorted({0, 1, (1 << k) - 1, *rng.integers(1 << k, size=5).tolist()})
    got = cv.to_affine_ints(params.g_dev[rows].unbind(1))
    if got != [ff.g1_mul(ff.G1_GEN, pow(tau, i, ff.R)) for i in rows]:
        raise AssertionError("k=22 SRS rows differ from the host g1_mul")
    kernels = results.setdefault("kernels", {})
    check_fixed_base(dev, srs.tau_powers_words(k, dev), srs.g1_table(dev),
                     params.g_dev, None, bound, kernels, tag="10 fixed_base",
                     twin_rows=1 << 14)
    v = rand_fr_bulk((1 << k,), rng, dev)       # Montgomery coefficients
    params.commit_log = []
    dv.reset_peak(dev)
    params.commit_coeff_mont(v)                 # warm
    point = params.commit_coeff_mont(v)
    commit_peak = dv.peak_bytes(dev)
    rec = params.commit_log[-1]
    params.commit_log = None
    t0 = time.perf_counter()
    std = fo.elementwise(fo.MUL, fo.FR, v, fo.const(fo.FR, 1, dev, mont=False)
                         .expand_as(v))
    host = native_msm_words(params.table(), std)
    host_s = time.perf_counter() - t0
    if point != host:
        raise AssertionError("the 2^22 device commit differs from the native "
                             "host Pippenger")
    split = ", ".join(f"{p} {t * 1e3:.1f}" for p, t in rec["split_s"].items())
    phase("10 k=22 commit", f"SRS 2^{k} on the card in {setup_s:.1f} s (peak "
          f"{setup_peak / gib:.2f} GiB; cache written and loaded back in "
          f"{load_s:.1f} s, equal; rows {rows} == host g1_mul); one device "
          f"commit of 2^{k} random scalars == native host Pippenger "
          f"({host_s:.1f} s): {rec['seconds']:.3f} s, split ms: {split}; max "
          f"bucket load {rec['max_load']}, max row load {rec['max_row_load']} "
          f"(target {rec['target']}), {rec['rows']} rows, {rec['adds']} adds; "
          f"peak {commit_peak / gib:.2f} GiB")
    check_msm_k22(dev, params.table(), std, host, bound, kernels)
    del std
    torch.cuda.empty_cache()
    # the transform at 2^22 runs three passes (8 + 7 + 7 stages)
    for inverse in (False, True):
        rev, tw, _n_inv = pn.device_plan(k, inverse, dev)
        h_rev, h_tw, _ = pn._plan(k, inverse)
        if not (np.array_equal(rev.cpu().numpy(), h_rev)
                and np.array_equal(fo.to_numpy(tw), h_tw)):
            raise AssertionError(f"the k=22 NTT plan built on the card differs "
                                 f"from the host plan, inverse={inverse}")
    x = rand_fr_bulk((1, 1 << k), rng, dev)
    before = build.LAUNCHES["ntt_transform"]
    fwd = pn.ntt_batch(x, k)
    passes = build.LAUNCHES["ntt_transform"] - before
    if passes != len(pn.pass_bounds(k)) or passes != 3:
        raise AssertionError(f"a 2^22 transform made {passes} launches, not 3")
    if not torch.equal(fwd, pn.ntt_batch_plain(x, k)):
        raise AssertionError("the 2^22 transform differs from its twin")
    if not torch.equal(pn.ntt_batch(fwd, k, inverse=True), x):
        raise AssertionError("inverse(forward(x)) != x at 2^22")
    ntt_ms = kernel_ms(lambda: pn.ntt_batch(x, k), "ntt_pass_kernel", 5, passes)
    phase("10 k=22 ntt", f"the plan built on the card == the host plan; one "
          f"2^22 vector in {passes} passes {pn.pass_bounds(k)} == its twin, "
          f"inverse(forward) == input; forward {ntt_ms:.4f} ms device")
    results["commit_k22"] = dict(
        ntt_ms=ntt_ms, ntt_passes=passes,
        setup_s=setup_s, setup_peak_bytes=setup_peak, cache_load_s=load_s,
        seconds=rec["seconds"], split_s=rec["split_s"],
        max_load=rec["max_load"], max_row_load=rec["max_row_load"],
        rows=rec["rows"], adds=rec["adds"], target=rec["target"],
        peak_bytes=commit_peak, host_s=host_s)
    return params


def crossover(dev, rng, points, results) -> None:
    """Phase 11a: `msm_ints` on the card against the native `g1_msm` at
    n = 2^4 .. 2^16 (the K=16 SRS's points, random scalars), equal at each
    n, both timed on the host clock (the best of CROSSOVER_REPS, each call
    ends with the point on the host). The crossover is the least n from
    which the card is faster at every larger n (None if it never is),
    printed beside the chips' default `DEVICE_MIN`."""
    from halo2_snark_aggregator_tpu_torch.arith.device_value import DEVICE_MIN
    from halo2_snark_aggregator_tpu_torch.ff import bn254 as ff
    from halo2_snark_aggregator_tpu_torch.ops import msm as pm

    scal = rand_ints(ff.R, len(points), rng)
    pm.msm_ints(points[:16], scal[:16], 8, dev)  # warm
    rows = []
    for e in range(4, 17):
        n = 1 << e
        host_t, dev_t = [], []
        for _ in range(CROSSOVER_REPS):
            t0 = time.perf_counter()
            want = ff.g1_msm(points[:n], scal[:n])
            host_t.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            got = pm.msm_ints(points[:n], scal[:n], 8, dev)
            dev_t.append(time.perf_counter() - t0)
            if got != want:
                raise AssertionError(f"msm_ints differs from the native g1_msm "
                                     f"at n={n}")
        rows.append((n, min(host_t) * 1e3, min(dev_t) * 1e3))
    cross = None
    for n, host_ms, dev_ms in reversed(rows):
        if dev_ms >= host_ms:
            break
        cross = n
    phase("11a crossover", "msm_ints on the card == native g1_msm at every n; "
          "best ms of %d (n: native / card): " % CROSSOVER_REPS + ", ".join(
              f"{n}: {h:.3f} / {d:.3f}" for n, h, d in rows)
          + f"; the card is faster from n = {cross} (DEVICE_MIN "
          f"{DEVICE_MIN})")
    results["crossover"] = dict(
        device_min=cross, rows=[dict(n=n, native_ms=h, card_ms=d)
                                for n, h, d in rows])


def store_value_pair(specs, store):
    """((w_x, w_g), its MSM sizes) of the value-context aggregation
    verifier over a folder's target proofs: the oracle of the SDK's
    verify_check."""
    from halo2_snark_aggregator_tpu_torch.arith.value import ValueContext, ValueEccChip
    from halo2_snark_aggregator_tpu_torch.protocol import verify as pv
    from halo2_snark_aggregator_tpu_torch.protocol.transcript import PoseidonTranscriptRead

    ctx = ValueContext()
    pchip = ValueEccChip()
    nchip = schip = pchip.scalar_chip
    circuits = []
    for spec in specs:
        vk, _cols = store.read_target_vkey(spec.name)
        pdata = [pv.ProofData(
            instances=[store.read_target_instance(spec.name, i)],
            transcript=PoseidonTranscriptRead(
                store.read_target_proof(spec.name, i), ctx, nchip),
            key=f"{spec.name}_{i}") for i in range(spec.n_proofs)]
        circuits.append(pv.CircuitProof(
            name=spec.name, vk=vk, params=store.read_target_params(spec.name),
            proofs=pdata))
    w_x, w_g, *_rest, ok = pv.verify_aggregation_proofs_in_chip(
        ctx, nchip, schip, pchip, circuits, PoseidonTranscriptRead(b"", ctx, nchip))
    if not ok:
        raise AssertionError("the value oracle rejected the folder's proofs")
    return (w_x, w_g), ctx.msm_sizes


def sdk_phase(dev, rng, bound, paths, read_path, params16, vk16, uniq,
              want16, params22, estimate_bytes, results) -> None:
    """Phase 11: the SDK on the card. 11a the hybrid chips' crossover; 11b
    `verify_aggregation_proofs_in_chip` over `make_device_chips` with every
    MSM on the card on the four K=16 proofs (== the value oracle's pair),
    then the CLI's sample_setup, sample_run and verify_check on a fresh
    folder under a temp dir (== the value pair); 11c verify_setup at
    agg_k=22; 11d verify_run at agg_k=22 (the same vk; the proof's spans,
    commit split and peak bytes beside the estimate; the aggregator's
    quotient program, transform and field kernel against their twins);
    11e verify_check_outer passes and fails a flipped byte; 11f the CLI's
    verify_check with the stored outer proof."""
    import tempfile

    from halo2_snark_aggregator_tpu_torch import device as dv
    from halo2_snark_aggregator_tpu_torch import fixtures
    from halo2_snark_aggregator_tpu_torch.arith.device_value import make_device_chips
    from halo2_snark_aggregator_tpu_torch.kernels import build
    from halo2_snark_aggregator_tpu_torch.prover import quotient_program
    from halo2_snark_aggregator_tpu_torch.prover.accel import StageTimer
    from halo2_snark_aggregator_tpu_torch.sdk import cli, harness
    from halo2_snark_aggregator_tpu_torch.utils.store import FolderStore

    gib = 1 << 30
    out = results.setdefault("sdk", {})
    crossover(dev, rng, params16.g_host_points(), out)

    # 11b: every multi_exp of the K=16 aggregation on the card
    build.reset_launches()
    chips = make_device_chips(dev, device_min=0)
    t0 = time.perf_counter()
    pair = value_oracle(params16, vk16, [p for p, _ in uniq],
                        [i for _, i in uniq], chips)
    hybrid_s = time.perf_counter() - t0
    read_path("hybrid_k16")
    ctx, pchip = chips[0], chips[3]
    if pair != want16:
        raise AssertionError("hybrid chips: the pair differs from the value "
                             "oracle's")
    n_msm = pchip.device_msms
    if not n_msm or n_msm != len(ctx.msm_sizes) or \
            paths["hybrid_k16"]["msm_accumulate"] != n_msm:
        raise AssertionError(f"{n_msm} device MSMs of {len(ctx.msm_sizes)}, "
                             f"{paths['hybrid_k16']['msm_accumulate']} "
                             f"accumulate launches")
    phase("11b hybrid", f"verify_aggregation_proofs_in_chip over "
          f"make_device_chips(device_min=0) on the {len(uniq)} K=16 proofs: "
          f"pair == value oracle; {n_msm} of {len(ctx.msm_sizes)} multi_exps "
          f"on the card (sizes {sorted(set(ctx.msm_sizes))}); {hybrid_s:.2f} s")
    out["hybrid"] = dict(device_msms=n_msm, msm_sizes=ctx.msm_sizes,
                         seconds=hybrid_s)

    specs = cli.demo_specs("simple")
    with tempfile.TemporaryDirectory() as tmp:
        folder = str(Path(tmp) / "sdk")
        store = FolderStore(folder)
        build.reset_launches()
        t0 = time.perf_counter()
        for cmd in ("sample_setup", "sample_run"):
            if cli.main(["-c", cmd, "-f", folder]) != 0:
                raise AssertionError(f"cli {cmd} failed")
        sample_s = time.perf_counter() - t0
        read_path("sdk_sample")
        t0 = time.perf_counter()
        if cli.main(["-c", "verify_check", "-f", folder]) != 0:
            raise AssertionError("cli verify_check failed")
        check_s = time.perf_counter() - t0
        pair = store.read_final_pair()
        want, sizes = store_value_pair(specs, store)
        if pair != want:
            raise AssertionError("the CLI's final pair differs from the value "
                                 "oracle's")
        device_min = make_device_chips(dev)[3].device_min
        phase("11b cli", f"sample_setup + sample_run on the card {sample_s:.1f} "
              f"s (launches {paths['sdk_sample']}), verify_check "
              f"{check_s:.1f} s; final pair == value oracle, w_x.x = "
              f"{pair[0][0]}; its MSM sizes {sizes}, "
              f"{sum(n >= device_min for n in sizes)} at or above device_min "
              f"{device_min} (the rest on the host)")
        out["cli"] = dict(sample_s=sample_s, verify_check_s=check_s,
                          msm_sizes=sizes, device_min=device_min)
        solidity_target(dev, folder, specs, paths, read_path, out)

        # 11c: the aggregator's keygen at agg_k=22
        timer = StageTimer(dev, True)
        build.reset_launches()
        dv.reset_peak(dev)
        t0 = time.perf_counter()
        vk_setup = harness.verify_setup(specs, store, agg_k=AGG_K, device=dev,
                                        timer=timer, params=params22)
        setup_s = time.perf_counter() - t0
        read_path("verify_setup_k22")
        fp = fixtures.vk_fingerprint(vk_setup)
        spans = " ".join(f"{k}={v:.2f}s/{timer.peak_bytes.get(k, 0) / gib:.2f}GiB"
                         for k, v in timer.seconds.items())
        phase("11c verify_setup", f"agg_k={AGG_K} keygen on the card "
              f"{setup_s:.1f} s; spans (seconds/peak) {spans}; vk fingerprint "
              f"{fp}; launches {paths['verify_setup_k22']}")
        out["verify_setup"] = dict(seconds=setup_s, spans_s=timer.seconds,
                                   spans_peak_bytes=timer.peak_bytes,
                                   fingerprint=fp)

        # 11d: the outer proof at agg_k=22
        timer, ktimer = StageTimer(dev, True), StageTimer(dev, True)
        params22.commit_log = []
        build.reset_launches()
        dv.reset_peak(dev)
        t0 = time.perf_counter()
        proof, instances = harness.verify_run(
            specs, store, agg_k=AGG_K, device=dev, timer=timer,
            keygen_timer=ktimer, params=params22)
        run_s = time.perf_counter() - t0
        read_path("verify_run_k22")
        log, params22.commit_log = params22.commit_log, None
        vk = store.read_verify_vkey()
        if fixtures.vk_fingerprint(vk) != fp:
            raise AssertionError("verify_run's vk differs from verify_setup's")
        n_keygen = len(vk.fixed_commitments) + len(vk.permutation_commitments)
        commits = [c for c in log[n_keygen:] if c["mode"] == "device"]
        split = {p: sum(c["split_s"][p] for c in commits)
                 for p in commits[0]["split_s"]}
        peak = max(max(timer.peak_bytes.values()), max(ktimer.peak_bytes.values()))
        spans = " ".join(f"{k}={v:.2f}s/{timer.peak_bytes.get(k, 0) / gib:.2f}GiB"
                         for k, v in timer.seconds.items())
        kspans = " ".join(f"{k}={v:.2f}s/{ktimer.peak_bytes.get(k, 0) / gib:.2f}GiB"
                          for k, v in ktimer.seconds.items())
        phase("11d verify_run", f"agg_k={AGG_K}: outer proof {len(proof)} B, "
              f"{len(instances[0])} public inputs, {run_s:.1f} s in all; vk "
              f"fingerprint {fp} == verify_setup's; keygen spans (seconds/peak) "
              f"{kspans}; proof spans {spans}; {len(commits)} proof commits, "
              f"split (s, summed) { {p: round(v, 3) for p, v in split.items()} }, "
              f"max row load {max(c['max_row_load'] for c in commits)}; peak "
              f"{peak / gib:.2f} GiB against the {estimate_bytes / gib:.2f} GiB "
              f"estimate (72 GB spill limit); launches {paths['verify_run_k22']}")
        out["verify_run"] = dict(
            seconds=run_s, proof_bytes=len(proof), public_inputs=len(instances[0]),
            spans_s=timer.seconds, spans_peak_bytes=timer.peak_bytes,
            keygen_spans_s=ktimer.seconds,
            keygen_spans_peak_bytes=ktimer.peak_bytes, commits=len(commits),
            commit_split_s=split, peak_bytes=peak, estimate_bytes=estimate_bytes)
        kernels = results.setdefault("kernels", {})
        check_program(dev, rng, vk, bound, kernels, slice_rows=1 << 12,
                      tag="11d program")
        torch.cuda.empty_cache()
        ext_cols = len(quotient_program.compile_quotient(
            vk.cs, 1, [0] * vk.cs.num_challenges, 0, 0, 0, 0)[1])
        check_ntt(dev, rng, bound, kernels, ext_cols, k=AGG_K,
                  twin_cols=(ext_cols - 1,), tag="11d ntt", check_plan=False)
        torch.cuda.empty_cache()
        check_elementwise(dev, rng, 1 << AGG_K, bound, kernels, tag="11d field",
                          twin_rows=1 << 18)
        torch.cuda.empty_cache()

        # 11e: the outer proof on values; a flipped byte fails
        t0 = time.perf_counter()
        harness.verify_check_outer(store, agg_k=AGG_K, device=dev, params=params22)
        outer_s = time.perf_counter() - t0
        off = last_eval_offset(proof, vk, 64)
        verdict = flipped_verdict(lambda: harness.verify_check_outer(
            store, agg_k=AGG_K, device=dev, params=params22), store, proof, off)
        phase("11e verify_check_outer", f"the outer proof verifies on values "
              f"({outer_s:.3f} s); flipped byte at offset {off} -> {verdict}")

        # 11f: the CLI's verify_check with the stored outer proof
        t0 = time.perf_counter()
        if cli.main(["-c", "verify_check", "-f", folder,
                     "--agg-k", str(AGG_K)]) != 0:
            raise AssertionError("cli verify_check with the outer proof failed")
        phase("11f cli verify_check", f"final pair and the stored outer proof "
              f"verified ({time.perf_counter() - t0:.1f} s, the k={AGG_K} SRS "
              f"from _cache/)")
        solidity_outer(store, specs, params22, out)


def last_eval_offset(proof: bytes, vk, point_bytes: int) -> int:
    """The low byte of a proof's last evaluation: the proof ends with one
    opening point a rotation set (64 bytes in the SHA-256 transcript, 32
    compressed in the Poseidon one). A flip there reaches the pairing; a
    flipped point byte fails at decompression."""
    from halo2_snark_aggregator_tpu_torch.protocol.queryplan import (
        query_plan, rotation_sets)

    return len(proof) - point_bytes * len(rotation_sets(query_plan(vk, 1))) - 32


def flipped_verdict(check, store, proof: bytes, off: int) -> str:
    """`check()` over the store with byte `off` of its outer proof flipped
    (the proof written back after): the exception it raised; a check that
    passes fails the smoke."""
    bad = bytearray(proof)
    bad[off] ^= 0x01
    store.write_verify_proof(bytes(bad))
    try:
        check()
        verdict = None
    except (RuntimeError, ValueError, AssertionError) as e:
        verdict = f"{type(e).__name__}: {e}"
    finally:
        store.write_verify_proof(proof)
    if verdict is None:
        raise AssertionError(f"a proof with byte {off} flipped passed")
    return verdict


def solidity_target(dev, folder, specs, paths, read_path, out) -> None:
    """Phase 11b': the CLI's verify_solidity on 11b's folder before any
    outer proof is stored (the target flow): a demo target proof made on
    the card with each transcript hash, both sources written and accepting
    it; the sha256 proof equal to the host prover's."""
    from halo2_snark_aggregator_tpu_torch.kernels import build
    from halo2_snark_aggregator_tpu_torch.prover.keygen import keygen
    from halo2_snark_aggregator_tpu_torch.prover.prove import create_proof
    from halo2_snark_aggregator_tpu_torch.sdk import cli, harness
    from halo2_snark_aggregator_tpu_torch.transcript.host import ShaWrite
    from halo2_snark_aggregator_tpu_torch.utils.store import FolderStore

    store = FolderStore(folder)
    spec = specs[0]
    secs, sizes = {}, {}
    build.reset_launches()
    for algo in ("sha256", "keccak256"):
        for name in ("verifier.sol", "verifier_packed.sol"):
            store._path(name).unlink(missing_ok=True)
        t0 = time.perf_counter()
        if cli.main(["-c", "verify_solidity", "-f", folder, "--algo", algo]) != 0:
            raise AssertionError(f"cli verify_solidity --algo {algo} failed")
        secs[algo] = time.perf_counter() - t0
        sizes[algo] = {name: store._path(name).stat().st_size
                       for name in ("verifier.sol", "verifier_packed.sol")}
        if f"{algo}(buf)" not in store._path("verifier.sol").read_text():
            raise AssertionError(f"verifier.sol does not hash with {algo}")
    read_path("sdk_solidity")
    run = harness.verify_solidity(specs, store, algo="sha256", device=dev)
    params = store.read_target_params(spec.name)
    _vk, pk = keygen(spec.circuit_builder(0), spec.k, params)
    circuit = spec.circuit_builder(1)
    host = create_proof(pk, params, [circuit], [spec.instance_builder(circuit)],
                        ShaWrite("sha256"), seed=0)
    if run.proof != host:
        raise AssertionError("verify_solidity's card proof differs from the "
                             "host prover's")
    phase("11b' cli verify_solidity", f"target flow on the card: sha256 "
          f"{secs['sha256']:.1f} s, keccak256 {secs['keccak256']:.1f} s; both "
          f"sources written (bytes {sizes}) and accepting the proof made on "
          f"the card; the sha256 proof == the host prover's ({len(host)} B); "
          f"{len(run.gen.cg.statements)} statements; launches "
          f"{paths['sdk_solidity']}")
    out["solidity_target"] = dict(seconds=secs, bytes=sizes,
                                  statements=len(run.gen.cg.statements))


def solidity_outer(store, specs, params22, out) -> None:
    """Phase 11g: verify_solidity over 11d's k=22 outer proof (the outer
    flow): both sources checked, linted, written and accepting the proof,
    verify_final_pair accepting the stored target pair; a flipped proof
    word rejected by both; the contract's sizes against EIP-170."""
    from halo2_snark_aggregator_tpu_torch.sdk import harness

    t0 = time.perf_counter()
    run = harness.verify_solidity(specs, store, agg_k=AGG_K, algo="sha256",
                                  device=params22.device, params=params22)
    total = time.perf_counter() - t0
    for name in run.sources:
        if store._path(name).read_text() != run.sources[name]:
            raise AssertionError(f"{name} was not written")
    # the low bit of the last evaluation: the word before the opening points
    vk = store.read_verify_vkey()
    bad = list(run.words)
    i = last_eval_offset(run.proof, vk, 64) // 32
    bad[i] ^= 1
    rejected = {}
    for name, text in run.sources.items():
        t0 = time.perf_counter()
        verdict = harness.solidity_verdict(text, run.gen.algo, bad, run.instances)
        if verdict == "accepted":
            raise AssertionError(f"{name} accepted a flipped proof word")
        rejected[name] = (verdict, time.perf_counter() - t0)
    prog = run.prog
    blob = len(prog.ops) + 32 * len(prog.cpool)
    phase("11g verify_solidity", f"outer flow over the k={AGG_K} proof "
          f"({len(run.proof)} B): both sources checked, linted, written and "
          f"accepting it, verify_final_pair accepting the stored target pair; "
          f"word {i} flipped -> " + ", ".join(
              f"{n} {v} ({t:.1f} s)" for n, (v, t) in rejected.items())
          + f"; {len(run.gen.cg.statements)} statements, "
          f"{run.gen.transcript_words} proof words, memory_size "
          f"{prog.memory_size}; packed blob {len(prog.ops)} B + constant pool "
          f"{32 * len(prog.cpool)} B = {blob} B against EIP-170's 24576 B; "
          f"verifier.sol {len(run.sources['verifier.sol'])} B of text; seconds "
          + ", ".join(f"{k} {v:.2f}" for k, v in run.seconds.items())
          + f"; {total:.1f} s in all")
    out["solidity_outer"] = dict(
        statements=len(run.gen.cg.statements),
        proof_words=run.gen.transcript_words, memory_size=prog.memory_size,
        ops_bytes=len(prog.ops), cpool_bytes=32 * len(prog.cpool),
        eip170_bytes=24576, seconds=run.seconds, total_s=total,
        flipped={n: v for n, (v, _t) in rejected.items()})


def recursion_phase(dev, paths, read_path, params22, out) -> None:
    """Phase 12: the second recursion layer at the reference bench's shape
    (bench.py:513-528): one demo target proof, the layer-1 outer proof with
    the Poseidon transcript at L1_K, verify_check_l1_poseidon (and a
    flipped byte failing it); the layer-2 circuit synthesized once for its
    rows, l2_k the least k that holds them; the CLI's verify2_run at l2_k
    (its keygen reusing that synthesis, timed by StageTimers), verify2_check
    (and a flipped byte failing it), the CLI's verify2_check."""
    import functools
    import tempfile

    from halo2_snark_aggregator_tpu_torch import device as dv
    from halo2_snark_aggregator_tpu_torch import fixtures
    from halo2_snark_aggregator_tpu_torch.circuits.aggregator import AggregatorCircuit
    from halo2_snark_aggregator_tpu_torch.kernels import build
    from halo2_snark_aggregator_tpu_torch.prover.accel import (StageTimer,
                                                               synthesize_keygen)
    from halo2_snark_aggregator_tpu_torch.prover.srs import unsafe_setup_accel
    from halo2_snark_aggregator_tpu_torch.sdk import cli, harness
    from halo2_snark_aggregator_tpu_torch.utils.store import FolderStore

    gib = 1 << 30

    def spans(timer):
        return " ".join(f"{k}={v:.2f}s/{timer.peak_bytes.get(k, 0) / gib:.2f}GiB"
                        for k, v in timer.seconds.items())

    rec = out.setdefault("recursion", {})
    spec = cli.demo_spec()
    spec.n_proofs = 1
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        folder = str(Path(tmp) / "recurse")
        store = FolderStore(folder)
        harness.sample_setup(spec, store, device=dev)
        harness.sample_run(spec, store, device=dev)

        # 12a: the layer-1 outer proof, Poseidon transcript, at L1_K
        build.reset_launches()
        t0 = time.perf_counter()
        params1 = unsafe_setup_accel(L1_K, device=dev)
        srs_s = time.perf_counter() - t0
        read_path("setup_k20")
        timer, ktimer = StageTimer(dev, True), StageTimer(dev, True)
        build.reset_launches()
        dv.reset_peak(dev)
        t0 = time.perf_counter()
        proof1, inst1 = harness.verify_run(
            [spec], store, agg_k=L1_K, transcript="poseidon", device=dev,
            timer=timer, keygen_timer=ktimer, params=params1)
        l1_s = time.perf_counter() - t0
        read_path("l1_run_k20")
        vk1 = store.read_verify_vkey()
        fp1 = fixtures.vk_fingerprint(vk1)
        t0 = time.perf_counter()
        harness.verify_check_l1_poseidon(store, L1_K, device=dev, params=params1)
        l1_check_s = time.perf_counter() - t0
        off = last_eval_offset(proof1, vk1, 32)
        verdict = flipped_verdict(lambda: harness.verify_check_l1_poseidon(
            store, L1_K, device=dev, params=params1), store, proof1, off)
        peak1 = max(max(timer.peak_bytes.values()), max(ktimer.peak_bytes.values()))
        phase("12a layer 1", f"SRS 2^{L1_K} {srs_s:.1f} s; verify_run at "
              f"k={L1_K}, Poseidon transcript: {len(proof1)} B, "
              f"{len(inst1[0])} public inputs, {l1_s:.1f} s in all; vk "
              f"fingerprint {fp1}; keygen spans (seconds/peak) {spans(ktimer)}; "
              f"proof spans {spans(timer)}; peak {peak1 / gib:.2f} GiB; "
              f"verify_check_l1_poseidon passes ({l1_check_s:.2f} s), byte "
              f"{off} flipped -> {verdict}; launches {paths['l1_run_k20']}")
        rec["layer1"] = dict(
            k=L1_K, seconds=l1_s, srs_s=srs_s, proof_bytes=len(proof1),
            fingerprint=fp1, spans_s=timer.seconds,
            spans_peak_bytes=timer.peak_bytes, keygen_spans_s=ktimer.seconds,
            keygen_spans_peak_bytes=ktimer.peak_bytes, peak_bytes=peak1,
            check_s=l1_check_s)

        # 12b: the layer-2 circuit's rows, from one keygen synthesis at
        # L2_K (at the next k if they overflow it)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        agg2 = AggregatorCircuit([harness.layer2_target(store, params1)])
        for k in range(L2_K, AGG_K + 1):
            try:
                asg = synthesize_keygen(agg2, k)
                break
            except ValueError as e:
                phase("12b layer-2 rows", f"2^{k} rows overflow: {e}")
        else:
            raise AssertionError(f"the layer-2 circuit needs more than "
                                 f"2^{AGG_K} rows")
        rows_s = time.perf_counter() - t0
        rows = asg.max_row_touched + 1
        l2_k = harness.smallest_k(asg)
        phase("12b layer-2 rows", f"{rows} rows (the 2^17-row range table "
              f"included; {asg.n - asg.usable_rows} blinding rows) from one "
              f"keygen synthesis at 2^{k} ({rows_s:.1f} s): l2_k = {l2_k}")
        if l2_k != k:
            asg = None  # not the synthesis of a key at l2_k

        # 12c: the CLI's verify2_run, its stage timed by StageTimers
        timer, ktimer = StageTimer(dev, True), StageTimer(dev, True)
        run2 = harness.verify2_run
        harness.verify2_run = functools.partial(
            run2, timer=timer, keygen_timer=ktimer, l1_params=params1,
            params=params22 if l2_k == AGG_K else None, assignment=asg)
        build.reset_launches()
        dv.reset_peak(dev)
        t0 = time.perf_counter()
        try:
            if cli.main(["-c", "verify2_run", "-f", folder,
                         "--agg-k", str(l2_k)]) != 0:
                raise AssertionError("cli verify2_run failed")
        finally:
            harness.verify2_run = run2
        l2_s = time.perf_counter() - t0
        read_path("l2_run")
        del asg
        l2 = FolderStore(Path(folder) / "l2")
        proof2 = l2.read_verify_proof()
        vk2 = l2.read_verify_vkey()
        fp2 = fixtures.vk_fingerprint(vk2)
        peak2 = max(max(timer.peak_bytes.values()), max(ktimer.peak_bytes.values()))
        params2 = params22 if l2_k == AGG_K else None
        t0 = time.perf_counter()
        harness.verify2_check(l2, l2_k, device=dev, params=params2)
        l2_check_s = time.perf_counter() - t0
        off = last_eval_offset(proof2, vk2, 64)
        verdict = flipped_verdict(lambda: harness.verify2_check(
            l2, l2_k, device=dev, params=params2), l2, proof2, off)
        t0 = time.perf_counter()
        if cli.main(["-c", "verify2_check", "-f", folder,
                     "--agg-k", str(l2_k)]) != 0:
            raise AssertionError("cli verify2_check failed")
        cli_check_s = time.perf_counter() - t0
        phase("12c layer 2", f"the CLI's verify2_run at l2_k={l2_k}: "
              f"{len(proof2)} B, {l2_s:.1f} s in all; vk fingerprint {fp2} "
              f"(layer 1's {fp1}); keygen spans (seconds/peak) {spans(ktimer)}; "
              f"proof spans {spans(timer)}; peak {peak2 / gib:.2f} GiB; "
              f"verify2_check passes ({l2_check_s:.2f} s), byte {off} flipped "
              f"-> {verdict}; the CLI's verify2_check passes "
              f"({cli_check_s:.1f} s); launches {paths['l2_run']}; phase "
              f"{time.perf_counter() - t_phase:.1f} s")
        rec["layer2"] = dict(
            k=l2_k, rows=rows, rows_s=rows_s, seconds=l2_s,
            proof_bytes=len(proof2), fingerprint=fp2, spans_s=timer.seconds,
            spans_peak_bytes=timer.peak_bytes, keygen_spans_s=ktimer.seconds,
            keygen_spans_peak_bytes=ktimer.peak_bytes, peak_bytes=peak2,
            check_s=l2_check_s, cli_check_s=cli_check_s)
        rec["seconds"] = time.perf_counter() - t_phase


def commit_ab(params, rng) -> str:
    """One host and one device commit of the same 2^16-scalar vector, in
    turns host, device, device, host; the two must agree."""
    from halo2_snark_aggregator_tpu_torch.ops import field as fo

    v = rand_field(fo.FR, (params.n,), rng, params.device)
    params.g_host_points()
    mode0 = params.commit_mode
    times, points = {"host": [], "device": []}, set()
    params.commit_log = []
    for mode in ("host", "device", "device", "host"):
        params.commit_mode = mode
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        points.add(params.commit_coeff_mont(v))
        times[mode].append(time.perf_counter() - t0)
    dev_log = [c for c in params.commit_log if c["mode"] == "device"]
    params.commit_log = None
    params.commit_mode = mode0
    if len(points) != 1:
        raise AssertionError("host and device commits differ")
    split = ", ".join(f"{k} {v * 1e3:.1f}" for k, v in dev_log[-1]["split_s"].items())
    return (f"host {times['host'][0]:.3f}/{times['host'][1]:.3f} s, device "
            f"{times['device'][0]:.3f}/{times['device'][1]:.3f} s (max bucket "
            f"load {dev_log[-1]['max_load']}, max row load "
            f"{dev_log[-1]['max_row_load']}, {dev_log[-1]['rows']} rows; "
            f"second device commit in ms: {split})")


# -- phase 13: the sharded paths ---------------------------------------------------


def seeded_fr(n: int, seed: int) -> np.ndarray:
    """n canonical Fr values as (n, 8) uint32 words, made on the host from
    `seed` (every rank of a world makes the same ones)."""
    from halo2_snark_aggregator_tpu_torch.ops import field as fo

    gen = torch.Generator().manual_seed(seed)
    w = torch.randint(0, 1 << 32, (n, 8), dtype=torch.int64, generator=gen)
    w[:, 7] %= int(fo.FR.p_words[7])
    return w.numpy().astype(np.uint32)


def shard_msm_leg(info, g_words, scalars, n_hosts=None):
    """13a / 13d (a rank): this rank's chunk of the affine table (g_words
    (n, 3, 8)) and of the standard-form scalars (n, 8), through the sharded
    MSM (every rank of the world) or the two-level MSM on an n_hosts x
    (world / n_hosts) grid, twice: (the point, the seconds of each run from
    the upload to the point)."""
    import torch.distributed as dist

    from halo2_snark_aggregator_tpu_torch.ops import field as fo
    from halo2_snark_aggregator_tpu_torch.ops import msm as msm_ops
    from halo2_snark_aggregator_tpu_torch.parallel import group as pg
    from halo2_snark_aggregator_tpu_torch.parallel import msm_shard, multihost

    groups = None if n_hosts is None else pg.host_groups(
        n_hosts, info.world // n_hosts)
    seconds = []
    for _ in range(2):  # the first run in a fresh process loads the kernels
        dist.barrier()
        t0 = time.perf_counter()
        lo, hi = msm_shard.chunk_bounds(len(scalars), info.rank, info.world)
        table = msm_ops.affine_table(
            fo.to_tensor(g_words[lo:hi], info.device).unbind(1))
        scal = fo.to_tensor(scalars[lo:hi], info.device)
        if groups is None:
            pt = msm_shard.msm_sharded(table, scal, 8, dist.group.WORLD)
        else:
            pt = multihost.msm_hier(table, scal, *groups, 8)
        seconds.append(time.perf_counter() - t0)
    return pt, seconds


def shard_ntt_leg(info, seed, k1, k2, inverse):
    """13b (a rank): the four-step transform of `seeded_fr(2^(k1+k2),
    seed)`: (this rank's rows of R as a host array, seconds)."""
    import torch.distributed as dist

    from halo2_snark_aggregator_tpu_torch.parallel import dryrun as dr

    x = seeded_fr(1 << (k1 + k2), seed)
    dist.barrier()
    t0 = time.perf_counter()
    r = dr.ntt_leg(info, x, k1, k2, inverse)
    return r, time.perf_counter() - t0


def shard_verify_leg(info, vk, params, reps):
    """13c (a rank): the sharded batched verifier over the K=16 proofs
    tiled to batch 128: (w_x, w_g, ok, seconds a verify over `reps` after
    a warm one, the last stage split, the flipped-byte verdict)."""
    import torch.distributed as dist

    from halo2_snark_aggregator_tpu_torch.bench import tiled_proofs
    from halo2_snark_aggregator_tpu_torch.protocol.batched import BatchedVerifier

    proofs, insts = tiled_proofs(16)
    bv = BatchedVerifier(vk, params, batch=len(proofs), sample_proof=proofs[0],
                         sample_instances=insts[0], device=info.device,
                         group=dist.group.WORLD)
    *_pair, ok = bv.verify(proofs, insts)  # warm
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        w_x, w_g, ok = bv.verify(proofs, insts)
        if not ok:
            break
    dt = (time.perf_counter() - t0) / reps
    stages = dict(bv.last_profile)
    off = next(ref for kind, ref in bv.manifest if kind == "scalar")
    bad = list(proofs)
    corrupt = bytearray(bad[5])
    corrupt[off] ^= 0x01
    bad[5] = bytes(corrupt)
    try:
        *_pair, bad_ok = bv.verify(bad, insts)
        verdict = f"ok={bad_ok}"
    except ValueError as e:
        bad_ok, verdict = False, f"ValueError: {e}"
    return w_x, w_g, ok, dt, stages, bad_ok, verdict


def rank_counts(outs, leg: str) -> dict:
    """One leg's launches by kernel, summed over the ranks of a world."""
    total: dict = {}
    for o in outs:
        for k, v in o.result[leg][1].items():
            total[k] = total.get(k, 0) + v
    return total


def shard_phase(dev, rng, paths, set_path, params16, vk16, uniq, want16,
                pair6, rate6, out) -> None:
    """Phase 13: the sharded paths (parallel/) on the card, each against
    the unsharded one. 13a the sharded MSM of the K=18 SRS's 2^18 points
    (uniform scalars) == msm_totals + the row combine == the native
    Pippenger, over a 1-rank NCCL group here and over 2 gloo ranks sharing
    cuda:0; 13b the four-step NTT at k = 22 (k1 = k2 = 11), forward and
    inverse, == `ntt_batch` word for word, on the same two worlds; 13c
    `BatchedVerifier(group=)` at K=16, batch 128, over the 2 ranks: the
    pair == phase 6's, the pairing passes, a flipped byte fails on both;
    13d the two-level MSM on 4 ranks (2 hosts x 2 chips on cuda:0) ==
    13a; 13e `verify_check(group=)` over the four K=16 proofs on the 2
    ranks, every MSM sharded (device_min 0) == phase 11b's pair; 13f the
    shuffle and synthetic circuits' proofs made on the card == the port's
    host `create_proof`. Ranks that share one card are no scaling
    measurement: their times say what the path costs there."""
    import tempfile

    import torch.distributed as dist

    from halo2_snark_aggregator_tpu_torch.circuits.shuffle import ShuffleCircuit
    from halo2_snark_aggregator_tpu_torch.circuits.synthetic import SyntheticCircuit
    from halo2_snark_aggregator_tpu_torch.kernels import build
    from halo2_snark_aggregator_tpu_torch.ops import field as fo
    from halo2_snark_aggregator_tpu_torch.ops import msm as msm_ops
    from halo2_snark_aggregator_tpu_torch.ops import ntt as nt
    from halo2_snark_aggregator_tpu_torch.parallel import dryrun as dr
    from halo2_snark_aggregator_tpu_torch.parallel import group as pg
    from halo2_snark_aggregator_tpu_torch.parallel import msm_shard, ntt_shard
    from halo2_snark_aggregator_tpu_torch.prover import accel, srs
    from halo2_snark_aggregator_tpu_torch.prover import keygen as hkeygen
    from halo2_snark_aggregator_tpu_torch.prover import kzg as pkzg
    from halo2_snark_aggregator_tpu_torch.prover import prove as hprove
    from halo2_snark_aggregator_tpu_torch.transcript.host import PoseidonWrite
    from halo2_snark_aggregator_tpu_torch.utils.store import FolderStore

    t_phase = time.perf_counter()
    k1 = k2 = SHARD_NTT_K // 2
    params18 = srs.setup_cached_accel(18, device=dev)
    table = params18.table()
    n = params18.n
    scal = rand_fr_bulk((n,), rng, dev)
    totals, weights = msm_ops.msm_totals(table, scal, 8)
    want_pt = msm_ops.combine_rows_host(totals.unbind(1), weights, 8)
    if want_pt is None or want_pt != native_msm_words(table, scal):
        raise AssertionError("13a: the unsharded MSM differs from the native "
                             "Pippenger")
    g_words, s_words = fo.to_numpy(params18.g_dev), fo.to_numpy(scal)
    seed = int(rng.integers(1 << 62))
    x = fo.to_tensor(seeded_fr(1 << SHARD_NTT_K, seed), dev)
    want_fwd = fo.to_numpy(nt.ntt_batch(x[None], SHARD_NTT_K)[0])
    want_inv = fo.to_numpy(nt.ntt_batch(x[None], SHARD_NTT_K, inverse=True)[0])
    del params18, totals, weights

    def same_ntt(r, want, what):
        if not (ntt_shard.ntt_sharded_to_host(r) == want).all():
            raise AssertionError(f"13b: {what} differs from ntt_batch")

    # 13a, 13b over a 1-rank NCCL group in this process
    with tempfile.TemporaryDirectory() as tmp:
        pg.init_group("nccl", dev, SHARD_TIMEOUT, f"file://{tmp}/rendezvous",
                      0, 1)
        try:
            build.reset_launches()
            nccl_msm_s = []
            for _ in range(2):  # the first call holds NCCL's first collective
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                got = msm_shard.msm_sharded(table, scal, 8)
                nccl_msm_s.append(time.perf_counter() - t0)
            set_path("shard_msm_nccl", dict(build.LAUNCHES))
            build.reset_launches()
            b = ntt_shard.shard_rows(x, k1, k2, 0, 1)
            times = []
            rs = []
            for inverse in (False, True):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                rs.append(fo.to_numpy(ntt_shard.ntt_sharded(b, k1, k2,
                                                            inverse=inverse)))
                times.append(time.perf_counter() - t0)
            set_path("shard_ntt_nccl", dict(build.LAUNCHES))
        finally:
            dist.destroy_process_group()
    if got != want_pt:
        raise AssertionError("13a: the 1-rank NCCL sharded MSM differs")
    same_ntt(rs[0], want_fwd, "the 1-rank NCCL forward")
    same_ntt(rs[1], want_inv, "the 1-rank NCCL inverse")
    del rs, b, x, table, scal
    phase("13a/13b nccl", f"backend nccl, 1 rank on {dev}: sharded MSM of "
          f"2^18 K=18 SRS points == msm_totals + combine == native Pippenger "
          f"({nccl_msm_s[0] * 1e3:.1f} ms, again {nccl_msm_s[1] * 1e3:.1f} ms); "
          f"four-step NTT k=22 (k1=k2={k1}) "
          f"forward and inverse == ntt_batch word for word ({times[0] * 1e3:.1f}"
          f" / {times[1] * 1e3:.1f} ms with the copy to the host); launches "
          f"{paths['shard_msm_nccl']}, {paths['shard_ntt_nccl']}")

    # 13a, 13b, 13c, 13e over 2 gloo ranks sharing the card
    hparams = pkzg.ParamsKZG(16, params16.g_host_points(), params16.g_lagrange,
                             params16.g2, params16.s_g2)
    with tempfile.TemporaryDirectory() as tmp:
        store = FolderStore(tmp)
        store.write_target_params("zkevm16", hparams)
        store.write_target_vkey("zkevm16", (vk16, {}))
        for i, (p, inst) in enumerate(uniq):
            store.write_target_proof("zkevm16", i, p)
            store.write_target_instance("zkevm16", i, inst)
        legs = [("msm", shard_msm_leg, (g_words, s_words)),
                ("ntt_fwd", shard_ntt_leg, (seed, k1, k2, False)),
                ("ntt_inv", shard_ntt_leg, (seed, k1, k2, True)),
                ("verify", shard_verify_leg, (vk16, hparams, REPS)),
                ("check", dr.check_leg, (tmp, [("zkevm16", 16, len(uniq))],
                                         0))]
        t0 = time.perf_counter()
        outs = pg.spawn(dr.run_legs, 2, "cuda", "gloo", SHARD_TIMEOUT,
                        args=(legs,))
        world2_s = time.perf_counter() - t0
        stored = store.read_final_pair()
    for leg, name in (("msm", "shard_msm"), ("ntt_fwd", "shard_ntt"),
                      ("verify", "shard_verify"), ("check", "shard_hybrid")):
        counts = rank_counts(outs, leg)
        if leg == "ntt_fwd":
            inv = rank_counts(outs, "ntt_inv")
            counts = {k: v + inv[k] for k, v in counts.items()}
        set_path(name, counts)
    res = [{k: v for k, (v, _c) in o.result.items()} for o in outs]
    for r, (o, rr) in enumerate(zip(outs, res)):
        if o.forbidden:
            raise AssertionError(f"rank {r} imported {o.forbidden[:5]}")
        if rr["msm"][0] != want_pt:
            raise AssertionError(f"13a: rank {r}'s sharded MSM differs")
        w_x, w_g, ok, _dt, _st, bad_ok, _v = rr["verify"]
        if not ok or (w_x, w_g) != pair6:
            raise AssertionError(f"13c: rank {r}: ok={ok}, pair == phase 6's: "
                                 f"{(w_x, w_g) == pair6}")
        if bad_ok:
            raise AssertionError(f"13c: rank {r} accepted a flipped byte")
        if tuple(rr["check"]) != want16:
            raise AssertionError(f"13e: rank {r}'s verify_check pair differs")
    same_ntt(np.concatenate([rr["ntt_fwd"][0] for rr in res]), want_fwd,
             "the 2-rank forward")
    same_ntt(np.concatenate([rr["ntt_inv"][0] for rr in res]), want_inv,
             "the 2-rank inverse")
    if stored != want16:
        raise AssertionError("13e: the stored final pair differs")
    verify_dt = max(rr["verify"][3] for rr in res)
    stages = res[0]["verify"][4]
    phase("13a gloo msm", f"backend gloo, 2 ranks sharing {dev}: the sharded "
          f"MSM of the 2^18 points == 13a's on every rank (ms by rank, first "
          f"and second run, upload included: "
          f"{[[round(t * 1e3, 1) for t in rr['msm'][1]] for rr in res]}); "
          f"launches {paths['shard_msm']}")
    phase("13b gloo ntt", f"backend gloo, 2 ranks sharing {dev}: k=22 forward "
          f"and inverse == ntt_batch word for word (ms by rank, forward / "
          f"inverse with the copies: "
          f"{[(round(rr['ntt_fwd'][1] * 1e3, 1), round(rr['ntt_inv'][1] * 1e3, 1)) for rr in res]}"
          f"); launches {paths['shard_ntt']}")
    phase("13c verify", f"backend gloo, 2 ranks sharing {dev}: "
          f"BatchedVerifier(group=) at K=16 batch 128: pair == phase 6's, "
          f"pairing ok, flipped byte -> {res[0]['verify'][6]} on rank 0 and "
          f"{res[1]['verify'][6]} on rank 1; {128 / verify_dt:.2f} proofs/s "
          f"(2 ranks on one card, the slower rank) beside phase 6's "
          f"{rate6:.2f} (1 process); stages of rank 0: "
          + " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in stages.items())
          + f"; launches {paths['shard_verify']}")
    phase("13e hybrid", f"backend gloo, 2 ranks sharing {dev}: "
          f"verify_check(group=) over the {len(uniq)} K=16 proofs, every "
          f"multi_exp sharded (device_min 0): pair == 11b's on both ranks, "
          f"rank 0 stored it; launches {paths['shard_hybrid']}; the 2-rank "
          f"world {world2_s:.1f} s with its start")
    out["nccl"] = dict(msm_ms=[t * 1e3 for t in nccl_msm_s], ntt_fwd_ms=times[0] * 1e3,
                       ntt_inv_ms=times[1] * 1e3)
    out["gloo2"] = dict(
        msm_ms=[[t * 1e3 for t in rr["msm"][1]] for rr in res],
        ntt_ms=[(rr["ntt_fwd"][1] * 1e3, rr["ntt_inv"][1] * 1e3) for rr in res],
        verify_proofs_per_s=128 / verify_dt, phase6_proofs_per_s=rate6,
        verify_stages_s=stages, world_s=world2_s)

    # 13d: the two-level MSM on 2 hosts x 2 chips, all on cuda:0
    t0 = time.perf_counter()
    outs = pg.spawn(dr.run_legs, 4, "cuda", "gloo", SHARD_TIMEOUT,
                    args=([("hier", shard_msm_leg, (g_words, s_words, 2))],))
    world4_s = time.perf_counter() - t0
    set_path("shard_hier", rank_counts(outs, "hier"))
    for r, o in enumerate(outs):
        if o.forbidden:
            raise AssertionError(f"rank {r} imported {o.forbidden[:5]}")
        if o.result["hier"][0][0] != want_pt:
            raise AssertionError(f"13d: rank {r}'s two-level MSM differs")
    phase("13d hier", f"backend gloo, 4 ranks (2 hosts x 2 chips) sharing "
          f"{dev}: the two-level MSM == 13a on every rank (ms by rank, first "
          f"and second run: "
          f"{[[round(t * 1e3, 1) for t in o.result['hier'][0][1]] for o in outs]}); "
          f"launches {paths['shard_hier']}; the world {world4_s:.1f} s")
    out["gloo4"] = dict(hier_ms=[[t * 1e3 for t in o.result["hier"][0][1]]
                                 for o in outs],
                        world_s=world4_s)

    # 13f: the shuffle and synthetic circuits proved on the card
    build.reset_launches()
    sizes = {}
    for name, make, k, seed_p in (
            ("shuffle", ShuffleCircuit, ShuffleCircuit.K, 5),
            ("synthetic", lambda: SyntheticCircuit(k=8, seed=5), 8, 4)):
        params = pkzg.ParamsKZG.unsafe_setup(k)
        circuit = make()
        aparams = accel.AccelParams.from_params(params, device=dev)
        _avk, apk = accel.keygen_accel(circuit, k, aparams)
        card = accel.create_proof_accel(apk, aparams, [circuit],
                                        [circuit.instances()], PoseidonWrite(),
                                        seed=seed_p)
        _vk, pk = hkeygen.keygen(circuit, k, params)
        host = hprove.create_proof(pk, params, [circuit], [circuit.instances()],
                                   PoseidonWrite(), seed=seed_p)
        if card != host:
            raise AssertionError(f"13f: the {name} proof made on the card "
                                 f"differs from the host prover's")
        sizes[name] = len(card)
    set_path("prove_extra", dict(build.LAUNCHES))
    seconds = time.perf_counter() - t_phase
    phase("13f circuits", f"shuffle (K=6, multi-phase) and synthetic (k=8) "
          f"proofs made on the card with device commits == the host "
          f"create_proof's bytes ({sizes} B); launches {paths['prove_extra']}; "
          f"phase 13 {seconds:.1f} s")
    out["seconds"] = seconds


SDK_PATHS = ("setup_k22", "hybrid_k16", "sdk_sample", "sdk_solidity",
             "verify_setup_k22", "verify_run_k22", "setup_k20", "l1_run_k20",
             "l2_run")


def shape_entry(r, paths, kname, path_names):
    """A kernel's readings at a later phase's shape for the kernels line
    (None for a kernel with no check there): its launches on each of
    `path_names` and its check at that shape."""
    if r is None:
        return None
    bound_ms, bound_by = r["bound"]
    return {"launches_by_path": {p: c[kname] for p, c in paths.items()
                                 if p in path_names and c[kname]},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "launch_ms": r["launch_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "shape": r["shape"],
            **{k: r[k] for k in ("plain_rows", "plain_columns", "instructions",
                                 "products", "slots", "columns", "smem_bytes",
                                 "chain_calls", "chain_ms", "plan_ms",
                                 "plan_device_ms", "forward_ms", "inverse_ms",
                                 "b1_ms", "b1_bound_ms", "checked") if k in r}}


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from halo2_snark_aggregator_tpu_torch import device as dv
    from halo2_snark_aggregator_tpu_torch import fixtures, native
    from halo2_snark_aggregator_tpu_torch import prove as pprove
    from halo2_snark_aggregator_tpu_torch.bench import card_info, tiled_proofs
    from halo2_snark_aggregator_tpu_torch.kernels import build
    from halo2_snark_aggregator_tpu_torch.parallel import group as pg
    from halo2_snark_aggregator_tpu_torch.protocol.batched import BatchedVerifier
    from halo2_snark_aggregator_tpu_torch.prover import quotient_program

    dev = dv.cuda_device()
    name = torch.cuda.get_device_name(0)
    card = card_info()
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=30, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bound = Bounds(sms, clock)
    phase("1 device", f"{name}; nvidia-smi: {card}; {sms} SMs, max SM clock "
          f"{clock:.0f} MHz; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build.library()
    t_nvcc = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native host library did not build")
    t_native = time.perf_counter() - t0
    usage = build.ptxas_usage(Path(build.BUILD_INFO["ptxas_log"]).read_text())
    ptxas = {k: usage[k] for k in PTXAS_SYMBOL.values()}
    sass = build.sass_counts()
    phase("2 build", f"nvcc {t_nvcc:.1f} s (sm_90a, one nvcc per source, "
          f"built={build.BUILD_INFO['built']}); g++ native {t_native:.1f} s; "
          f"one Montgomery product {sass['mont_mul']} SASS instructions "
          f"({sass['mont_mul_ops']}); ptxas, SASS instructions: " + ", ".join(
              f"{k} {u['registers']} registers, {u['stack']} B stack, "
              f"{u['spill_stores']}/{u['spill_loads']} B spill stores/loads, "
              f"{sass['kernels'].get(k)} instructions"
              for k, u in ptxas.items()))

    rates = build.imad_rates()
    phase("2 rates", "multiply-adds a clock an SM at the max SM clock (8 "
          "chains a thread, 8 blocks of 256 an SM; the op's count in the "
          "probe's SASS): " + ", ".join(
              f"{op} {rates[op]['per_ns_per_sm'] * 1e3 / clock:.2f} "
              f"({rates[op]['ms']:.3f} ms a launch, {rates[op]['in_kernel']} in "
              f"the kernel)" for op in ("IMAD", "IMAD.WIDE.U32"))
          + f"; wide over narrow {rates['wide_over_narrow']:.3f}")

    paths: dict[str, dict] = {}

    def set_path(path: str, counts: dict) -> None:
        paths[path] = {k: counts.get(k, 0) for k in build.KERNELS}
        missing = [k for k in PATH_KERNELS[path] if paths[path][k] == 0]
        if missing:
            raise AssertionError(f"{path} path did not launch {missing}")

    def read_path(path: str) -> None:
        set_path(path, build.LAUNCHES)

    build.reset_launches()
    params, vk, apk, timings = fixtures.setup(16, dev, "device")
    read_path("setup_keygen")
    if paths["setup_keygen"]["fixed_base"] != 1 or paths["setup_keygen"]["curve_padd"]:
        raise AssertionError("the SRS took more than one fixed-base launch "
                             "or a padd launch")
    phase("3 setup+keygen", f"K=16 SRS and zkevm-shape key on the card, vk "
          f"fingerprint {fixtures.workload(16).fingerprint}; setup "
          f"{timings['setup_s']:.1f} s, keygen {timings['keygen_s']:.1f} s "
          f"(device commits); launches {paths['setup_keygen']}")
    uniq = fixtures.workload(16).load_proofs()
    proofs, insts = tiled_proofs(16)
    t0 = time.perf_counter()
    bv = BatchedVerifier(vk, params, batch=len(proofs), sample_proof=proofs[0],
                         sample_instances=insts[0], device=dev)
    record_s = time.perf_counter() - t0

    rng = np.random.default_rng(SEED)
    results: dict = {}
    check_field(dev, rng, bv, bound, results)
    check_poseidon(dev, rng, bv, bound, results)
    check_msm(dev, rng, params, bound, results)
    check_fixed_base(dev, *check_padd(dev, rng, params, bound, results),
                     bound, results)
    ext_cols = len(quotient_program.compile_quotient(
        vk.cs, 1, [0] * vk.cs.num_challenges, 0, 0, 0, 0)[1])
    check_ntt(dev, rng, bound, results, ext_cols)
    check_program(dev, rng, vk, bound, results)

    t0 = time.perf_counter()
    want = value_oracle(params, vk, [p for p, _ in uniq], [i for _, i in uniq])
    oracle_s = time.perf_counter() - t0
    bv4 = BatchedVerifier(vk, params, batch=len(uniq), sample_proof=uniq[0][0],
                          sample_instances=uniq[0][1], device=dev)
    w_x, w_g, ok = bv4.verify([p for p, _ in uniq], [i for _, i in uniq])
    if not ok or (w_x, w_g) != want:
        raise AssertionError(f"batch-4 parity failed: ok={ok}, "
                             f"match={(w_x, w_g) == want}")
    phase("5 parity", f"batch 4 (w_x, w_g) == value oracle, pairing ok "
          f"(oracle {oracle_s:.1f} s)")

    build.reset_launches()
    *_pair, ok = bv.verify(proofs, insts)  # warm
    if not ok:
        raise AssertionError("batch-128 warm verify failed")
    t0 = time.perf_counter()
    for _ in range(REPS):
        *pair6, ok = bv.verify(proofs, insts)
        if not ok:
            raise AssertionError("batch-128 timed verify failed")
    dt = (time.perf_counter() - t0) / REPS
    pair6 = tuple(pair6)
    read_path("verify")
    if paths["verify"]["poseidon"] != REPS + 1:
        raise AssertionError(f"{paths['verify']['poseidon']} sponge launches "
                             f"over {REPS + 1} verifies, want one a verify")
    stages = " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in bv.last_profile.items())
    prof = dv.profile_device(lambda: bv.verify(proofs, insts), dev)
    top = ", ".join(f"{re.sub(r'[(<].*', '', k)} {c['count']}x {c['s'] * 1e3:.2f}ms"
                    for k, c in list(prof["by_kernel"].items())[:5])
    bv_rate = bv.batch / dt
    phase("6 main", f"batch {bv.batch} K=16 zkevm-shape: {bv_rate:.2f} "
          f"proofs/s ({dt:.3f} s/verify) on {card}; record {record_s:.1f} s; "
          f"launches over {REPS + 1} verifies {paths['verify']}; "
          f"{len(bv.tape.records)} tape records, "
          f"{sum(len(e) for e, _ in bv.msm_plans)} MSM entries/lane; "
          f"stages: {stages}; one more verify under torch.profiler: device "
          f"busy {prof['device_busy_s'] * 1e3:.2f} ms of {prof['wall_s']:.3f} s "
          f"({prof['device_busy_share']:.1%}); by kernel: {top}")

    off = next(ref for kind, ref in bv.manifest if kind == "scalar")
    bad = list(proofs)
    corrupt = bytearray(bad[5])
    corrupt[off] ^= 0x01
    bad[5] = bytes(corrupt)
    try:
        *_pair, ok = bv.verify(bad, insts)
        verdict = f"ok={ok}"
    except ValueError as e:
        ok, verdict = False, f"ValueError: {e}"
    if ok:
        raise AssertionError("corrupted proof was accepted")
    phase("7 negative", f"flipped scalar byte at offset {off} of proof 5 -> {verdict}")

    run = pprove.timed_proof(params, apk, 0)  # resets the counts first
    read_path("prove")
    if run["proof"] != uniq[0][0]:
        raise AssertionError("the proof made on the card differs from "
                             "zkevm_proof_k16_f98756fd8c860e04_0.json")
    split = " ".join(f"{k}={v:.2f}s" for k, v in run["stages_s"].items())
    ab = commit_ab(params, rng)
    fresh = [run["proof"]] + [p for p, _ in uniq[1:]]
    w_x, w_g, ok = bv4.verify(fresh, [i for _, i in uniq])
    if not ok or (w_x, w_g) != want:
        raise AssertionError("batch-4 verify of the new proof failed parity")
    phase("8 prove", f"K=16 proof 0 with device commits == committed bytes "
          f"({len(run['proof'])} B); {run['seconds']:.2f} s/proof; stages "
          f"{split}; {run['commits']} commits, slowest {run['commit_s_max']:.3f} s, "
          f"max bucket load {run['max_bucket_load']}, max row load "
          f"{run['max_row_load']}; commit split (s, summed) "
          f"{ {k: round(v, 3) for k, v in run['commit_split_s'].items()} }; "
          f"launches {paths['prove']}; "
          f"commit A/B {ab}; batch-4 verify with fixtures 1-3 == oracle")

    del bv, bv4
    torch.cuda.empty_cache()
    res18: dict = {}
    k18_phase(dev, rng, bound, paths, read_path, res18)
    torch.cuda.empty_cache()
    res22: dict = {}
    params22 = k22_commit(dev, rng, bound, read_path, res22)
    torch.cuda.empty_cache()
    sdk_phase(dev, rng, bound, paths, read_path, params, vk,
              uniq, want, params22,
              res18["prove"]["working_set"]["agg_k22_estimate_bytes"], res22)
    torch.cuda.empty_cache()
    recursion_phase(dev, paths, read_path, params22, res22["sdk"])
    del params22
    torch.cuda.empty_cache()
    res_shard: dict = {}
    shard_phase(dev, rng, paths, set_path, params, vk, uniq, want, pair6,
                bv_rate, res_shard)

    bad_mods = pg.forbidden_modules()
    if bad_mods:
        raise AssertionError(f"imported jax or the JAX package: {bad_mods[:5]}")
    print(json.dumps({"k18": {kk: res18[kk] for kk in ("prove", "verify",
                                                       "hybrid")},
                      "k22_commit": res22["commit_k22"], "sdk": res22["sdk"],
                      "shard": res_shard}))
    kernels = []
    for kname, (src, ref) in KERNEL_SOURCES.items():
        r = results[kname]
        by_path = {p: c[kname] for p, c in paths.items() if c[kname]}
        bound_ms, bound_by = r["bound"]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"halo2_snark_aggregator_tpu_torch/csrc/{src}",
            "replaces": f"halo2_snark_aggregator_tpu/{ref}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "launch_ms": r["launch_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "shape": r["shape"],
            **{k: r[k] for k in ("chain_calls", "chain_ms", "chain_launch_ms",
                                 "plan_ms", "plan_device_ms",
                                 "tree_ms", "tree_launch_ms",
                                 "b1_ms", "b1_launch_ms", "b1_plain_ms",
                                 "b1_bound_ms", "b1_inverse_ms",
                                 "b1_inverse_launch_ms", "forward_ms",
                                 "inverse_ms", "inverse_launch_ms",
                                 "inverse_plain_ms", "inverse_launches",
                                 "scale_replaces", "scale_ms",
                                 "scale_plain_ms", "scale_bound_ms",
                                 "instructions", "products", "slots",
                                 "columns", "smem_bytes", "plain_rows",
                                 "plain_columns") if k in r},
            "k18": shape_entry(res18["kernels"].get(kname), paths, kname,
                               ("setup_keygen_k18", "prove_k18", "verify_k18",
                                "hybrid_k18")),
            "sdk": shape_entry(res22["kernels"].get(kname), paths, kname,
                               SDK_PATHS),
            "ptxas": ptxas[PTXAS_SYMBOL[kname]],
            "sass_instructions": sass["kernels"].get(PTXAS_SYMBOL[kname])})
    print(json.dumps({"kernels": kernels}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
