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
// bound. Reduce: 32 threads (one per window) each run 2 x 255 serial
// complete adds; it is pure latency.
// Design: one thread per bucket lane reads its own points through the
// plan's order / starts / counts (no pre-gather and no fixed-trip dispatch
// loop: those existed for the TPU's sequential grid); one thread per window
// row for the reduce. Tables must be affine (z = 1): the mixed add is
// complete only for q != infinity, and the host plan drops digit-0 buckets,
// so identity table rows are never read. The additions live in curve.cuh,
// shared with the batched complete add of curve.cu.
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

// totals[w] = sum_{b >= 1} b * acc[w, b] via the running-sum sweep
__global__ void reduce_kernel(const uint32_t* acc, int64_t windows,
                              int64_t nbuckets, uint32_t* totals) {
  int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= windows) return;
  Pt running = identity();
  Pt total = identity();
  for (int64_t b = nbuckets - 1; b >= 1; b--) {
    running = full_add(running, pt_load(acc + (w * nbuckets + b) * 24));
    total = full_add(total, running);
  }
  pt_store(totals + w * 24, total);
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

// acc: (windows * nbuckets, 3, 8) projective buckets; totals: (windows, 3, 8).
extern "C" int h2t_msm_reduce(const void* acc, int64_t windows,
                              int64_t nbuckets, void* totals, void* stream) {
  if (windows == 0) return 0;
  const int threads = 32;
  dim3 grid((unsigned)((windows + threads - 1) / threads));
  h2t::reduce_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(acc), windows, nbuckets,
      static_cast<uint32_t*>(totals));
  return (int)cudaGetLastError();
}
