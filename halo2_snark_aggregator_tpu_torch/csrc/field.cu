// Batched BN254 field kernel: mul / add / sub / pow, with operands gathered
// and results scattered by row index; and the row-program kernel, which runs
// one straight-line program of Fr mul / add / sub per row of a domain.
//
// Replaces: halo2_snark_aggregator_tpu/ops/field_pallas.py `_kernel` (core
// `_mont_mul_block`), the batched Montgomery product over 16-bit limbs. In
// the port the same kernel also runs what the JAX package leaves to XLA on
// the verifier path: the tape's levelized Fr mul/add/sub, the batched
// Fermat inversions, phase B1's lambda scaling and de-Montgomery step, and
// the Fq square root of point decompression. The row program runs what the
// JAX prover's `_compute_h_sharded` evaluates as ~450 whole-column field
// ops a quotient shard (gates, permutation and lookup expressions, the
// fold by y), in one launch a shard.
//
// Bound on the card: integer multiply throughput and latency. One element
// is 64 32x32->64-bit multiply-adds for the product and 64 for REDC (a pow
// is ~380 products in a serial chain), against 64 bytes read and 32 written;
// the tape's levels are narrow (a few hundred elements x batch), so launch
// latency bounds most calls. A quotient shard at K=16 is ~230 products a
// row over 2^16 rows (~0.24 ms of IMADs) against ~76 columns of 2 MB read
// once (~45 us), so the row program is bound by operations.
// Design, elementwise: one thread per (row, lane) element, operands in
// registers, 16-byte vector loads of the 32-byte element; rows come from
// index arrays, so a tape level is one launch that reads and writes the
// slots buffer in place (rows written by a launch are never read by it).
// Design, row program (`field_program_kernel`): one thread per row i. The
// program (16 bytes an instruction), its column references (column,
// rotation) and its Montgomery constants are copied to shared memory once a
// block; every thread runs the same instruction, so the operand decode is a
// uniform branch. An operand is a slot, column c at rotation rot (read
// col_c[(i + rot) mod n], the rolled column without a copy), or a constant.
// Slots are a per-thread array of kProgSlots elements, indexed at run time,
// so they live in local memory (L1-cached, interleaved by thread, so a
// warp's slot accesses coalesce); the compiler (prover/quotient_program.py)
// allocates them by liveness and raises above the limit. Each intermediate
// stays in the row's slots: a shard reads each column from device memory
// and writes one output vector, where the elementwise launches read two and
// wrote one full vector per operation.
#include "field.cuh"

namespace h2t {

enum FieldMode { kMul = 0, kAdd = 1, kSub = 2, kPow = 3 };

struct Exponent {
  uint32_t w[8];
  int nbits;
};

template <int F>
__global__ void __launch_bounds__(128)
field_kernel(int mode, const uint32_t* a, const int32_t* a_idx,
             const uint32_t* b, const int32_t* b_idx, int b_bcast,
             uint32_t* out, const int32_t* out_idx, int64_t n_rows,
             int64_t lanes, Exponent e) {
  int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= n_rows * lanes) return;
  int64_t k = tid / lanes;
  int64_t lane = tid - k * lanes;
  int64_t ra = a_idx ? (int64_t)a_idx[k] : k;
  Fe x = fe_load(a + (ra * lanes + lane) * 8);
  Fe r;
  if (mode == kPow) {
    r = mont_pow<F>(x, e.w, e.nbits);
  } else {
    int64_t rb = b_idx ? (int64_t)b_idx[k] : k;
    Fe y = fe_load(b + (b_bcast ? rb : rb * lanes + lane) * 8);
    if (mode == kMul) {
      r = mont_mul<F>(x, y);
    } else if (mode == kAdd) {
      r = mod_add<F>(x, y);
    } else {
      r = mod_sub<F>(x, y);
    }
  }
  int64_t ro = out_idx ? (int64_t)out_idx[k] : k;
  fe_store(out + (ro * lanes + lane) * 8, r);
}

// The row program's slot count (ops/field.py PROGRAM_SLOTS).
constexpr int kProgSlots = 32;
enum OperandKind { kSlot = 0, kColumn = 1, kConst = 2 };

struct ProgramView {
  const int4* code;      // (op, dst slot, operand a, operand b)
  const int2* refs;      // (column, rotation)
  const uint32_t* consts;
};

__device__ __forceinline__ Fe program_operand(const ProgramView& p,
                                              const Fe* slot,
                                              const uint64_t* cols, int op,
                                              int64_t row, int64_t mask) {
  int kind = (unsigned)op >> 28, idx = op & 0x0fffffff;
  if (kind == kSlot) return slot[idx];
  if (kind == kColumn) {
    int2 ref = p.refs[idx];
    const uint32_t* c = reinterpret_cast<const uint32_t*>(cols[ref.x]);
    return fe_load(c + ((row + ref.y) & mask) * 8);
  }
  Fe v;
#pragma unroll
  for (int w = 0; w < 8; w++) v.w[w] = p.consts[idx * 8 + w];
  return v;
}

__global__ void __launch_bounds__(128)
field_program_kernel(const int4* code, int n_code, const int2* refs,
                     int n_refs, const uint32_t* consts, int n_consts,
                     const uint64_t* cols, int out_op, uint32_t* out,
                     int64_t n) {
  extern __shared__ __align__(16) unsigned char prog_smem[];
  int4* s_code = reinterpret_cast<int4*>(prog_smem);
  int2* s_refs = reinterpret_cast<int2*>(s_code + n_code);
  uint32_t* s_consts = reinterpret_cast<uint32_t*>(s_refs + n_refs);
  for (int i = threadIdx.x; i < n_code; i += blockDim.x) s_code[i] = code[i];
  for (int i = threadIdx.x; i < n_refs; i += blockDim.x) s_refs[i] = refs[i];
  for (int i = threadIdx.x; i < n_consts * 8; i += blockDim.x)
    s_consts[i] = consts[i];
  __syncthreads();
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int64_t mask = n - 1;
  const ProgramView p{s_code, s_refs, s_consts};
  Fe slot[kProgSlots];
  for (int pc = 0; pc < n_code; pc++) {
    const int4 ins = s_code[pc];
    Fe a = program_operand(p, slot, cols, ins.z, row, mask);
    Fe b = program_operand(p, slot, cols, ins.w, row, mask);
    Fe r;
    if (ins.x == kMul) {
      r = mont_mul<kFr>(a, b);
    } else if (ins.x == kAdd) {
      r = mod_add<kFr>(a, b);
    } else {
      r = mod_sub<kFr>(a, b);
    }
    slot[ins.y] = r;
  }
  fe_store(out + row * 8, program_operand(p, slot, cols, out_op, row, mask));
}

}  // namespace h2t

// Element (k, lane) reads a[a_idx[k], lane] and b[b_idx[k], lane] (b[b_idx[k]]
// when b_bcast) and writes out[out_idx[k], lane]; a null index array means
// the identity. exp_words is a host pointer to 8 words (pow mode only).
extern "C" int h2t_field(int mode, int field, const void* a,
                         const void* a_idx, const void* b, const void* b_idx,
                         int b_bcast, void* out, const void* out_idx,
                         int64_t n_rows, int64_t lanes,
                         const void* exp_words, int exp_bits, void* stream) {
  using namespace h2t;
  int64_t n = n_rows * lanes;
  if (n == 0) return 0;
  Exponent e;
  for (int i = 0; i < 8; i++)
    e.w[i] = exp_words ? static_cast<const uint32_t*>(exp_words)[i] : 0u;
  e.nbits = exp_bits;
  const int threads = 128;
  dim3 grid((unsigned)((n + threads - 1) / threads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto ua = static_cast<const uint32_t*>(a);
  auto ub = static_cast<const uint32_t*>(b);
  auto ia = static_cast<const int32_t*>(a_idx);
  auto ib = static_cast<const int32_t*>(b_idx);
  auto io = static_cast<const int32_t*>(out_idx);
  auto uo = static_cast<uint32_t*>(out);
  if (field == kFr) {
    field_kernel<kFr><<<grid, threads, 0, s>>>(mode, ua, ia, ub, ib, b_bcast,
                                               uo, io, n_rows, lanes, e);
  } else {
    field_kernel<kFq><<<grid, threads, 0, s>>>(mode, ua, ia, ub, ib, b_bcast,
                                               uo, io, n_rows, lanes, e);
  }
  return (int)cudaGetLastError();
}

// One straight-line Fr program per row of an n-row domain (n a power of
// two): code (n_code, 4) int32, refs (n_refs, 2) int32, consts (n_consts, 8)
// words, cols a device table of n_cols column pointers, every pointer and
// table on the device; the operands were checked against the tables by the
// caller (ops/field.run_program). out: (n, 8).
extern "C" int h2t_field_program(const void* code, int n_code,
                                 const void* refs, int n_refs,
                                 const void* consts, int n_consts,
                                 const void* cols, int out_op, void* out,
                                 int64_t n, void* stream) {
  using namespace h2t;
  if (n <= 0 || (n & (n - 1)) || n_code < 0 || n_refs < 0 || n_consts < 0)
    return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)n_code * 16 + (size_t)n_refs * 8 +
                (size_t)n_consts * 32;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        field_program_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = 128;
  dim3 grid((unsigned)((n + threads - 1) / threads));
  field_program_kernel<<<grid, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(code), n_code, static_cast<const int2*>(refs),
      n_refs, static_cast<const uint32_t*>(consts), n_consts,
      static_cast<const uint64_t*>(cols), out_op, static_cast<uint32_t*>(out),
      n);
  return (int)cudaGetLastError();
}
