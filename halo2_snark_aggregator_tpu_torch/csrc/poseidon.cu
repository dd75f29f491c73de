// Poseidon permutation over BN254 Fr (T=9, RATE=8, 4 full + 63 partial +
// 4 full rounds, S-box x^5), fused with the sponge absorb: a whole sponge
// chain of calls in one launch.
//
// Replaces: halo2_snark_aggregator_tpu/ops/poseidon_pallas.py `_make_kernel`
// (the whole-permutation VMEM kernel). In the port it carries phase A's
// sponge chain, which the JAX package runs as one lax.scan over the calls
// (arith/tape.py); here it is one launch over the tape's call table.
//
// Bound on the card: latency. The chain is serial (a call may read what an
// earlier call wrote), so a launch holds only `lanes` independent chains
// (128 at the main path's batch) and each permutation is 71 dependent
// rounds of Montgomery products; the IMAD bound of a 128-lane call is a few
// microseconds, so the time is the critical path of one state.
// Design: a group of 16 threads (half a warp, 9 of them active) per lane.
// Thread e owns state element e in registers. Each round it adds its round
// constant, applies the S-box (every thread in full rounds, thread 0 in
// partial ones), publishes its element to shared memory and, after
// __syncwarp, computes MDS row e: nine 512-bit products into one
// accumulator and ONE REDC (sum < 9p^2, three conditional subtracts), so a
// round's serial depth is 9 wide products, not the 81 of one thread a
// state. The round constants and the MDS matrix (23,040 B) are loaded into
// shared memory once per block; blocks of 4 groups spread 128 lanes over 32
// SMs. A group stays inside one warp, so __syncwarp orders both the state
// exchange and a call's slot writes before the next call's reads (st_idx
// may equal out_idx); slots are read through L2 (__ldcg), where those
// writes land.
#include "field.cuh"

namespace h2t {

constexpr int kT = 9;
constexpr int kRate = 8;
constexpr int kHalfF = 4;
constexpr int kRP = 63;
constexpr int kRounds = 2 * kHalfF + kRP;
constexpr int kGroup = 16;  // threads per lane: a half warp
constexpr int kGroupsPerBlock = 4;
constexpr int kChainThreads = kGroup * kGroupsPerBlock;

__device__ __forceinline__ Fe sbox(const Fe& x) {
  Fe x2 = mont_mul<kFr>(x, x);
  Fe x4 = mont_mul<kFr>(x2, x2);
  return mont_mul<kFr>(x4, x);
}

// a slot element read through L2, where this launch's earlier writes are
__device__ __forceinline__ Fe fe_load_cg(const uint32_t* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4 lo = __ldcg(s), hi = __ldcg(s + 1);
  return Fe{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
}

// Call c of lane L: state[e] = slots[st_idx[c, e], L] (+ slots[in_idx[c,
// e - 1], L] for 1 <= e <= n_in[c]) (+ 1 at e = pad_pos[c]); permute; write
// state[e] to slots[out_idx[c, e], L]. Calls run in order.
__global__ void __launch_bounds__(kChainThreads)
poseidon_chain_kernel(uint32_t* slots, int64_t lanes, int n_calls,
                      const int32_t* st_idx, const int32_t* in_idx,
                      const int32_t* n_in, const int32_t* pad_pos,
                      const int32_t* out_idx, const uint32_t* rc,
                      const uint32_t* mds) {
  __shared__ __align__(16) uint32_t sh_rc[kRounds * kT * 8];
  __shared__ __align__(16) uint32_t sh_mds[kT * kT * 8];
  __shared__ __align__(16) uint32_t sh_state[kGroupsPerBlock][2][kT * 8];
  for (int i = threadIdx.x; i < kRounds * kT * 2; i += kChainThreads)
    reinterpret_cast<uint4*>(sh_rc)[i] = reinterpret_cast<const uint4*>(rc)[i];
  for (int i = threadIdx.x; i < kT * kT * 2; i += kChainThreads)
    reinterpret_cast<uint4*>(sh_mds)[i] = reinterpret_cast<const uint4*>(mds)[i];
  __syncthreads();

  const int g = threadIdx.x / kGroup;
  const int e = threadIdx.x % kGroup;
  const int64_t lane = (int64_t)blockIdx.x * kGroupsPerBlock + g;
  if (e >= kT || lane >= lanes) return;
  // this group's 9 active threads within the warp
  const unsigned mask = 0x1FFu << (threadIdx.x & kGroup);
  const uint32_t* mds_row = sh_mds + e * kT * 8;

  for (int c = 0; c < n_calls; c++) {
    Fe s = fe_load_cg(slots + ((int64_t)st_idx[c * kT + e] * lanes + lane) * 8);
    if (e >= 1 && e <= n_in[c]) {
      const int64_t row = in_idx[c * kRate + e - 1];
      s = mod_add<kFr>(s, fe_load_cg(slots + (row * lanes + lane) * 8));
    }
    if (e == pad_pos[c]) s = mod_add<kFr>(s, fe_one<kFr>());

#pragma unroll 1
    for (int r = 0; r < kRounds; r++) {
      s = mod_add<kFr>(s, fe_load(sh_rc + (r * kT + e) * 8));
      if (e == 0 || r < kHalfF || r >= kHalfF + kRP) s = sbox(s);
      uint32_t* buf = sh_state[g][r & 1];  // double buffer: one barrier a round
      fe_store(buf + e * 8, s);
      __syncwarp(mask);
      Wide t;
      wide_zero(t);
#pragma unroll 1
      for (int j = 0; j < kT; j++)
        wide_mac(t, fe_load(mds_row + j * 8), fe_load(buf + j * 8));
      s = redc<kFr>(t, 3);
    }
    fe_store(slots + ((int64_t)out_idx[c * kT + e] * lanes + lane) * 8, s);
    __syncwarp(mask);
  }
}

}  // namespace h2t

// The sponge chain over `lanes` lanes of the slots buffer (rows x lanes x 8
// words), in place. Call table on the device, int32: st_idx (n_calls, 9),
// in_idx (n_calls, 8), n_in (n_calls), pad_pos (n_calls; -1: no pad
// marker), out_idx (n_calls, 9). rc (71, 9, 8) and mds (9, 9, 8) words.
extern "C" int h2t_poseidon_chain(void* slots, int64_t lanes, int n_calls,
                                  const void* st_idx, const void* in_idx,
                                  const void* n_in, const void* pad_pos,
                                  const void* out_idx, const void* rc,
                                  const void* mds, void* stream) {
  if (lanes == 0 || n_calls == 0) return 0;
  dim3 grid((unsigned)((lanes + h2t::kGroupsPerBlock - 1) /
                       h2t::kGroupsPerBlock));
  h2t::poseidon_chain_kernel<<<grid, h2t::kChainThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(slots), lanes, n_calls,
      static_cast<const int32_t*>(st_idx), static_cast<const int32_t*>(in_idx),
      static_cast<const int32_t*>(n_in), static_cast<const int32_t*>(pad_pos),
      static_cast<const int32_t*>(out_idx), static_cast<const uint32_t*>(rc),
      static_cast<const uint32_t*>(mds));
  return (int)cudaGetLastError();
}
