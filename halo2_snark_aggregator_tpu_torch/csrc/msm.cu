// Pippenger MSM over BN254 G1: bucket accumulate and bucket reduce.
//
// Replaces: halo2_snark_aggregator_tpu/ops/msm_pallas.py `_accum_kernel`
// (per-(row, bucket) lane of a split row plan: acc <- t < count ? acc + q_t
// : acc, RCB15 Algorithm 8 mixed add) and `_make_reduce_kernel` (per row,
// sweep b = B-1..1: running += S_b; total += running, RCB15 Algorithm 7).
//
// Accumulate. The plan (ops/msm.py `bucket_plan_split`, the reference's
// `host_bucket_plan_split` built on the card) cuts every window whose
// largest bucket holds more than `target` points into rows: lane r * B + b
// sums at most `target` points of row r's bucket b, reading the shared
// sorted order of window weights[r]. Each step is one mixed add (11
// Montgomery products) on Fq in registers. Bound on the card: operations,
// the same 2,087,263 mixed adds at the prover's 2^16 commit (c = 8,
// uniform scalars), 0.362 ms of IMADs; but the kernel is latency-bound, one
// dependent chain of adds a lane. The plain plan's chain was the largest
// bucket, 1,433-1,633 adds (byte 31 of a 254-bit scalar only takes
// 0..0x30, piling ~1,500 points into each of ~49 buckets) over 32 x 256 =
// 8,192 lanes; the split plan's depth is target = 128 adds over 106 rows x
// 256 = 27,136 lanes (20,198 holding points), ~6.4 warps an SM on 132 SMs.
// Design: one thread a lane, one projective accumulator from the identity,
// affine (z = 1) tables; the next point's 64 bytes (and its index before
// them) are loaded before the current add, so the gather, out of the 50 MB
// L2 that holds the 4 MB table, overlaps the add instead of waiting in
// front of it. No fixed-trip dispatch loop and no pregather (both existed
// for the TPU's sequential grid). The mixed add is complete only for q !=
// infinity; the plan drops digit-0 buckets and the caller zeroes the
// scalars of identity rows, so identity table rows are never read.
// Reduce: 2 (B - 1) complete adds a row, a chain of dependent adds: it is
// latency-bound too, so its design cuts the dependent adds.
// Design, reduce: sum_{b>=1} b S_b = sum_i U_i with U_i = sum_{k>=i} x_k over
// the positions x_i = S_{i+1}, i < n = B - 1. One block per row, T <= 256
// threads; thread t owns the L = ceil(n / 256) positions [tL, tL + L)
// (positions past n are the identity). (1) each thread sums its segment top
// down; (2) a Hillis-Steele suffix scan over the threads in shared memory
// turns that into V_t = U_{tL}; (3) each thread walks its segment up,
// U_{i+1} = U_i + (-x_i), summing its U; (4) a tree sums the threads'
// totals. The critical path is 3 (L - 1) + 2 ceil(log2 T) complete adds:
// 16 at B = 256, against 2 (B - 1) = 510 for the serial sweep. The
// additions live in curve.cuh, shared with the batched complete add of
// curve.cu; ops/msm.py `accumulate_plain` and `reduce_plain` make the same
// adds in the same order.
#include "curve.cuh"

namespace h2t {

constexpr int kAccumThreads = 128;

// acc[r * B + b] = sum of table[order[weights[r], starts[r, b] + t]] for
// t < counts[r, b], in order of t
__global__ void __launch_bounds__(kAccumThreads)
accumulate_kernel(const uint32_t* __restrict__ tx,
                  const uint32_t* __restrict__ ty,
                  const int32_t* __restrict__ order,
                  const int32_t* __restrict__ starts,
                  const int32_t* __restrict__ counts,
                  const int32_t* __restrict__ weights, int64_t rows,
                  int64_t nbuckets, int64_t n, uint32_t* __restrict__ acc) {
  int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= rows * nbuckets) return;
  const int cnt = counts[lane];
  Pt a = identity();
  if (cnt > 0) {
    const int32_t* pts =
        order + (int64_t)weights[lane / nbuckets] * n + starts[lane];
    int64_t idx = pts[0];
    Fe x = fe_ldg(tx + idx * 8), y = fe_ldg(ty + idx * 8);
    for (int t = 0; t < cnt; t++) {
      // point t + 1 (at the end, the last point again) is in flight while
      // point t is added
      const int64_t next = __ldg(pts + min(t + 1, cnt - 1));
      const Fe nx = fe_ldg(tx + next * 8), ny = fe_ldg(ty + next * 8);
      a = mixed_add(a, x, y);
      x = nx;
      y = ny;
    }
  }
  pt_store(acc + lane * 24, a);
}

constexpr int kReduceThreads = 256;

__device__ __forceinline__ Pt neg(const Pt& p) {
  return Pt{p.x, mod_sub<kFq>(fe_zero(), p.y), p.z};
}

// totals[r] = sum_{b >= 1} b * acc[r, b] by the suffix-sum scan above:
// block r, blockDim.x = T threads, seg = L positions a thread.
__global__ void __launch_bounds__(kReduceThreads, 1)
reduce_kernel(const uint32_t* acc, int64_t nbuckets, int seg,
              uint32_t* totals) {
  __shared__ Pt sh[kReduceThreads];
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int64_t n = nbuckets - 1;
  const int64_t lo = (int64_t)t * seg;
  const uint32_t* x = acc + ((int64_t)blockIdx.x * nbuckets + 1) * 24;
  auto at = [&](int64_t i) { return i < n ? pt_load(x + i * 24) : identity(); };

  // (1) the segment's sum, top down
  Pt run = at(lo + seg - 1);
  for (int m = seg - 2; m >= 0; m--) run = full_add(run, at(lo + m));
  // (2) inclusive suffix scan over the threads: run <- V_t = U_{lo}
  sh[t] = run;
  __syncthreads();
  for (int d = 1; d < nt; d *= 2) {
    const bool live = t + d < nt;
    Pt other;
    if (live) other = sh[t + d];
    __syncthreads();
    if (live) {
      run = full_add(run, other);
      sh[t] = run;
    }
    __syncthreads();
  }
  // (3) the segment's U_i, bottom up, and their sum
  Pt u = run, total = run;
  for (int m = 1; m < seg; m++) {
    u = full_add(u, neg(at(lo + m - 1)));
    total = full_add(total, u);
  }
  // (4) tree sum of the threads' totals
  sh[t] = total;
  __syncthreads();
  for (int d = 1; d < nt; d *= 2) {
    if (t % (2 * d) == 0 && t + d < nt) {
      total = full_add(total, sh[t + d]);
      sh[t] = total;
    }
    __syncthreads();
  }
  if (t == 0) pt_store(totals + (int64_t)blockIdx.x * 24, total);
}

}  // namespace h2t

// tx, ty: (n, 8) affine Montgomery Fq words; order: (windows, n); starts,
// counts: (rows, nbuckets); weights: (rows,) window of each row; acc:
// (rows * nbuckets, 3, 8).
extern "C" int h2t_msm_accumulate(const void* tx, const void* ty,
                                  const void* order, const void* starts,
                                  const void* counts, const void* weights,
                                  int64_t rows, int64_t nbuckets, int64_t n,
                                  void* acc, void* stream) {
  int64_t lanes = rows * nbuckets;
  if (lanes == 0) return 0;
  const int threads = h2t::kAccumThreads;
  dim3 grid((unsigned)((lanes + threads - 1) / threads));
  h2t::accumulate_kernel<<<grid, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tx), static_cast<const uint32_t*>(ty),
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(weights), rows, nbuckets, n,
      static_cast<uint32_t*>(acc));
  return (int)cudaGetLastError();
}

// acc: (rows * nbuckets, 3, 8) projective buckets; totals: (rows, 3, 8).
// threads, seg: the scan's shape (ops/msm.py `reduce_shape`).
extern "C" int h2t_msm_reduce(const void* acc, int64_t rows,
                              int64_t nbuckets, int threads, int seg,
                              void* totals, void* stream) {
  if (rows == 0) return 0;
  if (threads < 1 || threads > h2t::kReduceThreads || seg < 1 ||
      (int64_t)threads * seg < nbuckets - 1)
    return (int)cudaErrorInvalidValue;
  h2t::reduce_kernel<<<(unsigned)rows, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(acc), nbuckets, seg,
      static_cast<uint32_t*>(totals));
  return (int)cudaGetLastError();
}
