// Batched complete G1 addition, and the SRS's fixed-base sum.
//
// Replaces: halo2_snark_aggregator_tpu/ops/curve_pallas.py `_kernel` (core
// `_padd_block`), RCB15 Algorithm 7 with b3 = 9 over canonical Montgomery
// Fq limbs, complete for every input pair (identity, doubling, inverse),
// and the tree of its launches that the JAX package's
// prover/srs.fixed_base_msm runs: 32 table points a scalar summed in 5
// levels, one program a level (a TPU compile limit, not a property of the
// sum).
//
// Bound on the card: integer multiply-adds. One complete add is 12
// Montgomery products against 192 bytes read and 96 written; one mixed add
// 11 products against 64 bytes of table. A product is ~190 instructions,
// 135 of them wide multiply-adds on the IMAD pipe (csrc/field.cuh), so both
// kernels are bound by operations, not by bytes.
//
// padd_kernel (`padd`, the batched complete add): one thread per pair, the
// whole add in registers (csrc/curve.cuh `full_add`, the formula msm.cu's
// reduce uses), 16-byte vector loads of each 32-byte coordinate; no masks,
// since the formula is complete. A warp's load touches 32 sectors at the
// 96-byte point stride, half of each, and the next load finds the other
// half in L1; at 2^20 pairs on an H100 the kernel moves 302 MB in ~0.25
// ms (37 % of the HBM rate) at 80 % of its IMAD bound, so the points are
// not staged through shared memory.
//
// fixed_base_kernel (`fixed_base`, the SRS): out[i] = sum over positions j
// < 32 of T[j][d_ij], where d_ij is byte j of scalar i and T[j][d] = d
// 2^(8j) G is the (32 * 256, 3, 8) affine table (768 KB: it stays in the
// 50 MB L2). One launch does the whole sum:
//  * the scalars are read as their standard-form words (32 B each), the
//    digits cut from them in registers; no digit tensor, no gather;
//  * one thread a scalar walks its 32 positions in order: its first
//    nonzero digit's point becomes its accumulator (x : y : 1), each later
//    one is added by the mixed add (curve.cuh `mixed_add`, RCB15 Algorithm
//    8); a zero digit is skipped, so the identity row T[j][0] never reaches
//    the mixed add, which is complete only for q != infinity; a scalar
//    with no nonzero digit gives the identity;
//  * the next position's row is loaded before the current add, so the
//    gather out of L2 overlaps the add.
// At 2^16 scalars (the K=16 setup) the card is full with one thread a
// scalar: splitting a scalar's positions over 2, 4 or 8 threads, with a
// tree of complete adds over warp shuffles, took 1.04, 1.20 and 1.61 times
// as long on an H100 (the ratio of their total products), so the split is
// not made. ops/curve.py `fixed_base_plain` makes the same adds in the
// same order.
#include "curve.cuh"

namespace h2t {

constexpr int kCurveThreads = 128;
constexpr int kWindow = 8;
constexpr int kPositions = 256 / kWindow;  // 32 digits a scalar

__global__ void __launch_bounds__(kCurveThreads)
padd_kernel(const uint32_t* a, const uint32_t* b, uint32_t* out, int64_t m) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  pt_store(out + i * 24, full_add(pt_load(a + i * 24), pt_load(b + i * 24)));
}

// scalars (n, 8) standard-form words; table (32 * 256, 3, 8) affine rows;
// out (n, 3, 8) projective.
__global__ void __launch_bounds__(kCurveThreads)
fixed_base_kernel(const uint32_t* __restrict__ scalars,
                  const uint32_t* __restrict__ table,
                  uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t* s = scalars + i * 8;
  auto digit = [&](int j) { return (__ldg(s + (j >> 2)) >> ((j & 3) * 8)) & 0xffu; };
  auto row = [&](int j, uint32_t d) {
    return table + ((int64_t)j * (1 << kWindow) + d) * 24;
  };
  Pt acc = identity();
  uint32_t d = digit(0);
  Fe x = fe_ldg(row(0, d)), y = fe_ldg(row(0, d) + 8);
  bool started = false;
#pragma unroll 1
  for (int j = 0; j < kPositions; j++) {
    // position j + 1's row (at the end, this one again) is in flight while
    // position j is added
    const int jn = min(j + 1, kPositions - 1);
    const uint32_t dn = digit(jn);
    const Fe xn = fe_ldg(row(jn, dn)), yn = fe_ldg(row(jn, dn) + 8);
    if (d != 0) {
      if (started) {
        acc = mixed_add(acc, x, y);
      } else {
        acc = Pt{x, y, fe_one<kFq>()};
        started = true;
      }
    }
    d = dn;
    x = xn;
    y = yn;
  }
  pt_store(out + i * 24, acc);
}

}  // namespace h2t

// a, b, out: (m, 3, 8) projective Montgomery Fq words; out may alias a or b.
extern "C" int h2t_curve_padd(const void* a, const void* b, void* out,
                              int64_t m, void* stream) {
  if (m == 0) return 0;
  const int threads = h2t::kCurveThreads;
  dim3 grid((unsigned)((m + threads - 1) / threads));
  h2t::padd_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), m);
  return (int)cudaGetLastError();
}

// scalars: (n, 8) standard-form words (any 256-bit values); table: the
// (32 * 256, 3, 8) affine digit table, row j * 256 + d = d 2^(8j) G, row
// j * 256 the identity; out: (n, 3, 8) projective, out[i] = scalars[i] G.
extern "C" int h2t_fixed_base(const void* scalars, const void* table,
                              void* out, int64_t n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int threads = h2t::kCurveThreads;
  dim3 grid((unsigned)((n + threads - 1) / threads));
  h2t::fixed_base_kernel<<<grid, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(scalars),
      static_cast<const uint32_t*>(table), static_cast<uint32_t*>(out), n);
  return (int)cudaGetLastError();
}
