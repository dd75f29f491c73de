// Pippenger MSM over BN254 G1: bucket accumulate and bucket reduce.
//
// Replaces: halo2_snark_aggregator_tpu/ops/msm_pallas.py `_accum_kernel`
// (per-(window, bucket) lane: acc <- t < count ? acc + q_t : acc, RCB15
// Algorithm 8 mixed add) and `_make_reduce_kernel` (per window row, sweep
// b = B-1..1: running += S_b; total += running, RCB15 Algorithm 7).
//
// Bound on the card. Accumulate: the serial depth is the largest bucket
// load; each step is one mixed add (11 Montgomery products) on Fq in
// registers plus a 64-byte gather of the affine point. At the verifier's
// shape (32 windows x 256 buckets = 8192 lanes over ~10^4 points) the card
// holds one warp per SM at most, so it is latency-bound, not throughput-
// bound. Reduce: 2 (B - 1) complete adds a window over 32 windows are a
// few microseconds of IMADs, but a window's sum is a chain of dependent
// adds: it is latency-bound too, so its design cuts the dependent adds.
// Design, accumulate: one thread per bucket lane reads its own points
// through the plan's order / starts / counts (no pre-gather and no
// fixed-trip dispatch loop: those existed for the TPU's sequential grid).
// Tables must be affine (z = 1): the mixed add is complete only for
// q != infinity, and the host plan drops digit-0 buckets, so identity table
// rows are never read.
// Design, reduce: sum_{b>=1} b S_b = sum_i U_i with U_i = sum_{k>=i} x_k over
// the positions x_i = S_{i+1}, i < n = B - 1. One block per window, T <= 256
// threads; thread t owns the L = ceil(n / 256) positions [tL, tL + L)
// (positions past n are the identity). (1) each thread sums its segment top
// down; (2) a Hillis-Steele suffix scan over the threads in shared memory
// turns that into V_t = U_{tL}; (3) each thread walks its segment up,
// U_{i+1} = U_i + (-x_i), summing its U; (4) a tree sums the threads'
// totals. The critical path is 3 (L - 1) + 2 ceil(log2 T) complete adds:
// 16 at B = 256, against 2 (B - 1) = 510 for the serial sweep. The
// additions live in curve.cuh, shared with the batched complete add of
// curve.cu; ops/msm.py `reduce_plain` makes the same adds in the same order.
#include "curve.cuh"

namespace h2t {

// acc[w, b] = sum of table[order[w, starts[w,b] + t]] for t < counts[w,b]
__global__ void __launch_bounds__(128)
accumulate_kernel(const uint32_t* tx, const uint32_t* ty,
                  const int32_t* order, const int32_t* starts,
                  const int32_t* counts, int64_t windows, int64_t nbuckets,
                  int64_t n, uint32_t* acc) {
  int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= windows * nbuckets) return;
  int64_t w = lane / nbuckets;
  const int32_t* row = order + w * n + starts[lane];
  int cnt = counts[lane];
  Pt a = identity();
  for (int t = 0; t < cnt; t++) {
    int64_t idx = row[t];
    a = mixed_add(a, fe_load(tx + idx * 8), fe_load(ty + idx * 8));
  }
  pt_store(acc + lane * 24, a);
}

constexpr int kReduceThreads = 256;

__device__ __forceinline__ Pt neg(const Pt& p) {
  return Pt{p.x, mod_sub<kFq>(fe_zero(), p.y), p.z};
}

// totals[w] = sum_{b >= 1} b * acc[w, b] by the suffix-sum scan above:
// block w, blockDim.x = T threads, seg = L positions a thread.
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

// tx, ty: (n, 8) affine Montgomery Fq words; order: (windows, n);
// starts, counts: (windows, nbuckets); acc: (windows * nbuckets, 3, 8).
extern "C" int h2t_msm_accumulate(const void* tx, const void* ty,
                                  const void* order, const void* starts,
                                  const void* counts, int64_t windows,
                                  int64_t nbuckets, int64_t n, void* acc,
                                  void* stream) {
  int64_t lanes = windows * nbuckets;
  if (lanes == 0) return 0;
  const int threads = 128;
  dim3 grid((unsigned)((lanes + threads - 1) / threads));
  h2t::accumulate_kernel<<<grid, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tx), static_cast<const uint32_t*>(ty),
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(counts), windows, nbuckets, n,
      static_cast<uint32_t*>(acc));
  return (int)cudaGetLastError();
}

// acc: (windows * nbuckets, 3, 8) projective buckets; totals: (windows, 3,
// 8). threads, seg: the scan's shape (ops/msm.py `reduce_shape`).
extern "C" int h2t_msm_reduce(const void* acc, int64_t windows,
                              int64_t nbuckets, int threads, int seg,
                              void* totals, void* stream) {
  if (windows == 0) return 0;
  if (threads < 1 || threads > h2t::kReduceThreads || seg < 1 ||
      (int64_t)threads * seg < nbuckets - 1)
    return (int)cudaErrorInvalidValue;
  h2t::reduce_kernel<<<(unsigned)windows, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(acc), nbuckets, seg,
      static_cast<uint32_t*>(totals));
  return (int)cudaGetLastError();
}
