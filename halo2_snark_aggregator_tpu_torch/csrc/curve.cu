// Batched complete G1 addition: out[i] = a[i] + b[i] on projective points.
//
// Replaces: halo2_snark_aggregator_tpu/ops/curve_pallas.py `_kernel` (core
// `_padd_block`), RCB15 Algorithm 7 with b3 = 9 over canonical Montgomery
// Fq limbs, complete for every input pair (identity, doubling, inverse).
// On the prover path it runs the levels of the SRS fixed-base add tree
// (prover/srs.fixed_base_msm): 32 selected points per SRS element summed
// in 5 levels.
//
// Bound on the card: integer multiply-adds. One add is 12 Montgomery
// products (~3,200 32-bit IMADs) against 192 bytes read and 96 written, so
// at the SRS tree's widths (up to 2^20 adds a level) the IMAD rate bounds it.
// Design: one thread per pair, the whole add in registers (the formula is
// csrc/curve.cuh `full_add`, the one msm.cu's reduce uses), 16-byte vector
// loads of each 32-byte coordinate; no masks, since the formula is complete.
#include "curve.cuh"

namespace h2t {

__global__ void __launch_bounds__(128)
padd_kernel(const uint32_t* a, const uint32_t* b, uint32_t* out, int64_t m) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  pt_store(out + i * 24, full_add(pt_load(a + i * 24), pt_load(b + i * 24)));
}

}  // namespace h2t

// a, b, out: (m, 3, 8) projective Montgomery Fq words; out may alias a or b.
extern "C" int h2t_curve_padd(const void* a, const void* b, void* out,
                              int64_t m, void* stream) {
  if (m == 0) return 0;
  const int threads = 128;
  dim3 grid((unsigned)((m + threads - 1) / threads));
  h2t::padd_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), m);
  return (int)cudaGetLastError();
}
