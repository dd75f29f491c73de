// Radix-2 NTT over BN254 Fr, batched: one launch runs a pass of several
// butterfly stages on tiles in shared memory; the inverse's 1/n scale is
// the last pass's epilogue.
//
// Replaces: halo2_snark_aggregator_tpu/ops/ntt_pallas.py `_butterfly_kernel`
// (lo = u + v * tw, hi = u - v * tw over a limb-major (16, n) block), run by
// `_ntt_fused` over all k stages as one program, and `_scale_kernel` (x * n^-1
// by a Montgomery constant), which `_ntt_fused` runs in the same program.
// The port keeps the element-major (n, 8) word layout of every other
// kernel.
//
// Bound on the card: integer multiply-adds. A transform of 2^k points is
// k 2^(k-1) butterflies of one Montgomery product (~264 32-bit IMADs) each:
// at k = 16, 138 M IMADs, ~8.3 us on 132 SMs, against 2 MB read and 2 MB
// written (~1.3 us at HBM rate). One 2^16 vector is only 32,768 butterflies
// a stage, ~2 warps a scheduler if each stage were its own launch, so the
// design fuses stages and takes many columns in one launch.
//
// Design (ops/ntt.py `pass_bounds`, `_pass_plain` is the twin):
//  * A pass runs stages [s0, s1), m = s1 - s0 <= 10 of them. Row i = hi 2^s1
//    + t 2^s0 + l: for fixed (hi, l) the P = 2^m rows t = 0 .. P-1 are one
//    independent transform of the pass (a "group"); stage s pairs t and
//    t + 2^(s-s0) with twiddle table row 2^s - 1 + (t mod 2^(s-s0)) 2^s0 + l.
//  * At k = 16 the passes are 8 + 8 stages: two launches a batch. With at
//    most 10 stages a pass, two passes reach k = 20; a third takes k <= 27.
//    Passes of at most 10 stages were chosen over one 2^11-row first pass
//    (64 KB a tile, 32 blocks for a 2^16 vector) so that every tile fits
//    the default 48 KB of shared memory and a lone vector can be cut into
//    enough blocks for the card.
//  * A block holds G groups of one column, up to G P = 1024 rows (32 KB)
//    where the pass allows (G <= 2^s0 in a later pass, so the block's
//    groups are consecutive l and every t-row of the tile is G contiguous
//    elements: 4 x 32 B = one 128 B line at k = 16), as long as the launch
//    keeps at least two blocks an SM (the SM count read from the device):
//    on an H100's 132 SMs a 2^16 vector alone runs 256 blocks of 256 rows a
//    pass, the quotient's 76 columns 4,864 blocks of 1024.
//    grid.y is the column.
//  * The tile sits in shared memory as eight word planes (word w of tile
//    row j at w * E + j), so a warp's butterflies read consecutive banks
//    (two-way conflicts below stride 32) instead of the 32-byte element
//    stride of an element-major tile.
//  * Pass 1 reads row i from x[brev(i)] (no gather, no copy of the input)
//    and, for a coset extension, multiplies it by coset[brev(i)]; it writes
//    `out`. Later passes update `out` in place: a block reads all its rows
//    before it writes any, and no two blocks share a row.
//  * Up to 256 threads a block loop over the tile's E / 2 butterflies; one
//    __syncthreads a stage.
//  * The last pass of an inverse transform multiplies each element by the
//    constant n^-1 as it stores the tile: one Montgomery product an element
//    where a separate scale launch read and wrote every element once more.
//    The epilogue adds n products to the transform's k n / 2 (12.5 % at
//    k = 16); folding n^-1 into the last stage's twiddles (lo = u c + v (w
//    c), hi = u c - v (w c)) would save half of them.
#include "field.cuh"

namespace h2t {

constexpr int kNttTileRows = 1024;
constexpr int kNttThreads = 256;
constexpr int kNttBlocksPerSm = 2;  // the least blocks a launch keeps an SM

__device__ __forceinline__ void tile_load(uint32_t* sm, int E, int j,
                                          const Fe& v) {
#pragma unroll
  for (int w = 0; w < 8; w++) sm[w * E + j] = v.w[w];
}

__device__ __forceinline__ Fe tile_read(const uint32_t* sm, int E, int j) {
  Fe v;
#pragma unroll
  for (int w = 0; w < 8; w++) v.w[w] = sm[w * E + j];
  return v;
}

// x, out: (b, 2^k, 8); tw: the (2^k - 1, 8) stage table; coset: (2^k, 8) or
// null; lg = log2 G. Block (blockIdx.x, column blockIdx.y).
__global__ void __launch_bounds__(kNttThreads)
ntt_pass_kernel(const uint32_t* x, uint32_t* out, const uint32_t* tw,
                const uint32_t* coset, int k, int s0, int s1, int lg,
                int bitrev, Fe scale, int scaled) {
  extern __shared__ uint32_t sm[];
  const int m = s1 - s0;
  const int P = 1 << m, G = 1 << lg, E = P << lg;
  const int64_t n = 1LL << k;
  const int64_t col = blockIdx.y;
  const int64_t blk = blockIdx.x;
  x += col * n * 8;
  out += col * n * 8;
  const int64_t lmask = (1LL << s0) - 1;

  // element e of the tile -> (tile row j = g P + t, global row)
  auto locate = [&](int e, int& j) -> int64_t {
    if (s0 == 0) {  // G consecutive groups of P contiguous rows
      j = e;
      return blk * E + e;
    }
    int g = e & (G - 1), t = e >> lg;  // e runs over l fastest
    int64_t gg = blk * G + g;
    j = (g << m) + t;
    return ((gg >> s0) << s1) + ((int64_t)t << s0) + (gg & lmask);
  };

  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    int j;
    int64_t row = locate(e, j);
    int64_t src = bitrev ? (int64_t)(__brev((unsigned)row) >> (32 - k)) : row;
    Fe v = fe_load(x + src * 8);
    if (coset) v = mont_mul<kFr>(v, fe_load(coset + src * 8));
    tile_load(sm, E, j, v);
  }
  __syncthreads();

  const int halfP = P >> 1;
  for (int s = s0; s < s1; s++) {
    const int h = 1 << (s - s0);
    for (int q = threadIdx.x; q < (E >> 1); q += blockDim.x) {
      int g = q >> (m - 1), qq = q & (halfP - 1);
      int jj = qq & (h - 1);
      int lo = (g << m) + ((qq - jj) << 1) + jj;
      int hi = lo + h;
      int64_t l = s0 ? ((blk * G + g) & lmask) : 0;
      int64_t twrow = (1LL << s) - 1 + ((int64_t)jj << s0) + l;
      Fe u = tile_read(sm, E, lo);
      Fe v = mont_mul<kFr>(tile_read(sm, E, hi), fe_load(tw + twrow * 8));
      tile_load(sm, E, lo, mod_add<kFr>(u, v));
      tile_load(sm, E, hi, mod_sub<kFr>(u, v));
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    int j;
    int64_t row = locate(e, j);
    Fe v = tile_read(sm, E, j);
    if (scaled) v = mont_mul<kFr>(v, scale);
    fe_store(out + row * 8, v);
  }
}

}  // namespace h2t

// The current device's SM count, read once a device.
static cudaError_t sm_count(int64_t* sms) {
  static int cached[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!cached[dev]) {
    int v = 0;
    err = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    cached[dev] = v;
  }
  *sms = cached[dev];
  return cudaSuccess;
}

// Stages [s0, s1) of b transforms of 2^k points: x, out (b, 2^k, 8)
// Montgomery Fr words; tw the (2^k - 1, 8) twiddle table of ops/ntt._plan;
// with bitrev, row i reads x[brev_k(i)] (times coset[brev_k(i)] when coset
// is not null) and out must not alias x; without it out may alias x. scale:
// null, or a host pointer to 8 canonical words (the Montgomery form of
// n^-1 for an inverse's last pass) by which each stored element is
// multiplied. 1 <= s1 - s0 <= 10, s1 <= k <= 27.
extern "C" int h2t_ntt_pass(const void* x, void* out, const void* tw,
                            const void* coset, const void* scale, int64_t b,
                            int k, int s0, int s1, int bitrev, void* stream) {
  using namespace h2t;
  const int m = s1 - s0;
  if (m < 1 || m > 10 || s0 < 0 || s1 > k || k > 27 || b < 0 || b > 65535)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  int64_t sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  // G groups a block: up to 1024 rows, consecutive l in a later pass, while
  // the grid keeps kNttBlocksPerSm blocks an SM
  const int64_t min_blocks = kNttBlocksPerSm * sms;
  int lg = 0;
  int room = s0 ? s0 : k - s1;  // log2 of the groups that may share a block
  while (lg < room && (1 << (m + lg + 1)) <= kNttTileRows &&
         b * (1LL << (k - m - lg - 1)) >= min_blocks)
    lg++;
  const int E = 1 << (m + lg);
  const int threads = E / 2 < kNttThreads ? E / 2 : kNttThreads;
  dim3 grid((unsigned)(1LL << (k - m - lg)), (unsigned)b);
  size_t smem = (size_t)E * 8 * sizeof(uint32_t);
  Fe c = {};
  if (scale)
    for (int i = 0; i < 8; i++) c.w[i] = static_cast<const uint32_t*>(scale)[i];
  ntt_pass_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(tw), static_cast<const uint32_t*>(coset),
      k, s0, s1, lg, bitrev, c, scale != nullptr);
  return (int)cudaGetLastError();
}
