// Radix-2 NTT over BN254 Fr: one butterfly stage, and the inverse's 1/n
// scale.
//
// Replaces: halo2_snark_aggregator_tpu/ops/ntt_pallas.py `_butterfly_kernel`
// (lo = u + v * tw, hi = u - v * tw over a limb-major (16, n) block) and
// `_scale_kernel` (x * n^-1 by a Montgomery constant). The port keeps the
// element-major (n, 8) word layout of every other kernel; the bit reversal
// before the stages is a plain index in ops/ntt.py.
//
// Bound on the card: device memory. A stage at n = 2^16 reads and writes
// 2 MB of elements and reads up to 1 MB of twiddles against ~264 32-bit
// IMADs per butterfly, well under the IMAD rate; the scale reads and writes
// n elements with one product each.
// Design: one thread per butterfly, in place (the two rows a butterfly
// touches belong to it alone), 16-byte vector loads; stage s reads its 2^s
// twiddles from one device table of n - 1 rows (ops/ntt._plan), cached per
// (k, inverse), so no twiddle is tiled or recomputed. One launch per stage:
// stages are not fused.
#include "field.cuh"

namespace h2t {

// x: (n, 8) in place; tw: the stage's `half` twiddles; m = n / 2
__global__ void __launch_bounds__(128)
ntt_butterfly_kernel(uint32_t* x, const uint32_t* tw, int64_t half,
                     int64_t m) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  int64_t j = i & (half - 1);
  int64_t lo = ((i - j) << 1) + j;  // block (i / half) * 2 half + j
  int64_t hi = lo + half;
  Fe u = fe_load(x + lo * 8);
  Fe v = mont_mul<kFr>(fe_load(x + hi * 8), fe_load(tw + j * 8));
  fe_store(x + lo * 8, mod_add<kFr>(u, v));
  fe_store(x + hi * 8, mod_sub<kFr>(u, v));
}

__global__ void __launch_bounds__(128)
ntt_scale_kernel(const uint32_t* x, uint32_t* out, Fe c, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fe_store(out + i * 8, mont_mul<kFr>(fe_load(x + i * 8), c));
}

}  // namespace h2t

// x: (n, 8) Montgomery Fr words, updated in place; tw: (half, 8) Montgomery
// twiddles of the stage; half is a power of two and n a multiple of 2 half.
extern "C" int h2t_ntt_butterfly(void* x, const void* tw, int64_t n,
                                 int64_t half, void* stream) {
  int64_t m = n / 2;
  if (m == 0) return 0;
  const int threads = 128;
  dim3 grid((unsigned)((m + threads - 1) / threads));
  h2t::ntt_butterfly_kernel<<<grid, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(x), static_cast<const uint32_t*>(tw), half, m);
  return (int)cudaGetLastError();
}

// out[i] = x[i] * c * 2^-256 mod r; c is a host pointer to 8 canonical
// words (the Montgomery form of n^-1); out may alias x.
extern "C" int h2t_ntt_scale(const void* x, void* out, const void* c,
                             int64_t n, void* stream) {
  if (n == 0) return 0;
  h2t::Fe cw;
  for (int i = 0; i < 8; i++) cw.w[i] = static_cast<const uint32_t*>(c)[i];
  const int threads = 128;
  dim3 grid((unsigned)((n + threads - 1) / threads));
  h2t::ntt_scale_kernel<<<grid, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), cw, n);
  return (int)cudaGetLastError();
}
