// BN254 Fr / Fq Montgomery arithmetic on 8 little-endian 32-bit words.
//
// Shared by every kernel of the port (field.cu, poseidon.cu, msm.cu,
// curve.cu, ntt.cu). An element is a canonical Montgomery value a*2^256 mod
// p held as uint32_t[8]. All multi-word arithmetic runs on PTX carry chains
// (add.cc / addc, sub.cc / subc, mad.lo.cc / madc.hi.cc): one instruction a
// word, where 64-bit C++ sums cost a wide multiply-add plus a carry add and
// shift. The product `mont_mul` is an interleaved CIOS Montgomery product
// with separate even and odd accumulators; the Poseidon MDS row sum keeps
// its 512-bit accumulator (`wide_mac`, sum of 9 products < 9p^2) and one
// word-serial REDC (`redc`).
//
// The constants below are checked against ff/bn254.py by the port's CPU
// tests (tests/test_torch_field.py parses this header).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace h2t {

enum FieldId { kFr = 0, kFq = 1 };

// moduli, little-endian words
static __constant__ uint32_t kP[2][8] = {
    {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
     0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u},
    {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
     0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u},
};
// -p^{-1} mod 2^32
static __constant__ uint32_t kPinv[2] = {0xefffffffu, 0xe4866389u};
// 2^256 mod p (Montgomery one)
static __constant__ uint32_t kOne[2][8] = {
    {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
     0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
    {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
     0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
};

struct Fe {
  uint32_t w[8];
};

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.w[i] = 0u;
  return r;
}

template <int F>
__device__ __forceinline__ Fe fe_one() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.w[i] = kOne[F][i];
  return r;
}

__device__ __forceinline__ Fe fe_load(const uint32_t* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4 lo = s[0], hi = s[1];
  Fe r;
  r.w[0] = lo.x; r.w[1] = lo.y; r.w[2] = lo.z; r.w[3] = lo.w;
  r.w[4] = hi.x; r.w[5] = hi.y; r.w[6] = hi.z; r.w[7] = hi.w;
  return r;
}

// a read-only element through the non-coherent cache
__device__ __forceinline__ Fe fe_ldg(const uint32_t* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4 lo = __ldg(s), hi = __ldg(s + 1);
  Fe r;
  r.w[0] = lo.x; r.w[1] = lo.y; r.w[2] = lo.z; r.w[3] = lo.w;
  r.w[4] = hi.x; r.w[5] = hi.y; r.w[6] = hi.z; r.w[7] = hi.w;
  return r;
}

__device__ __forceinline__ void fe_store(uint32_t* dst, const Fe& a) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(a.w[0], a.w[1], a.w[2], a.w[3]);
  d[1] = make_uint4(a.w[4], a.w[5], a.w[6], a.w[7]);
}

// -- PTX carry chains ----------------------------------------------------------
// One instruction each. A chain is a run of these calls: `_cc` writes the
// carry (or borrow) flag, `c` in the name reads it. Every statement is
// volatile, so the compiler keeps them in program order, and no other
// code between the calls of a chain touches the flag (plain C++ compiles
// to PTX instructions without `.cc`). A flag set by a subtract is read
// only by a subtract: after sub.cc the card's flag is not the borrow that
// an add-with-carry would read. ptxas sees whole chains and maps
// independent ones onto separate carry predicates.
namespace ptx {

__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
// lo / hi word of a * b, plus c (plus the flag in madc), flag out in _cc
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b,
                                              uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_lo(uint32_t a, uint32_t b,
                                            uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b,
                                            uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

}  // namespace ptx

// x <- x - p when x >= p (x < 2^256), branch-free: the borrow of x - p
// selects the word set
template <int F>
__device__ __forceinline__ void cond_sub_p(Fe& x) {
  Fe d;
  d.w[0] = ptx::sub_cc(x.w[0], kP[F][0]);
#pragma unroll
  for (int j = 1; j < 8; j++) d.w[j] = ptx::subc_cc(x.w[j], kP[F][j]);
  const uint32_t keep = ptx::subc(0u, 0u);  // all ones when x < p
#pragma unroll
  for (int j = 0; j < 8; j++) x.w[j] = (x.w[j] & keep) | (d.w[j] & ~keep);
}

// (a + b) mod p for canonical a, b (p < 2^254: the sum never carries out)
template <int F>
__device__ __forceinline__ Fe mod_add(const Fe& a, const Fe& b) {
  Fe r;
  r.w[0] = ptx::add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int j = 1; j < 7; j++) r.w[j] = ptx::addc_cc(a.w[j], b.w[j]);
  r.w[7] = ptx::addc(a.w[7], b.w[7]);
  cond_sub_p<F>(r);
  return r;
}

// (a - b) mod p for canonical a, b: a - b, then + p times the borrow bit
// (read by subc, see above)
template <int F>
__device__ __forceinline__ Fe mod_sub(const Fe& a, const Fe& b) {
  Fe r;
  r.w[0] = ptx::sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int j = 1; j < 8; j++) r.w[j] = ptx::subc_cc(a.w[j], b.w[j]);
  const uint32_t borrow = ptx::subc(0u, 0u) & 1u;  // 1 when a < b
  r.w[0] = ptx::mad_lo_cc(kP[F][0], borrow, r.w[0]);
#pragma unroll
  for (int j = 1; j < 7; j++) r.w[j] = ptx::madc_lo_cc(kP[F][j], borrow, r.w[j]);
  r.w[7] = ptx::madc_lo(kP[F][7], borrow, r.w[7]);
  return r;
}

// 512-bit accumulator t[0..16]
struct Wide {
  uint32_t w[17];
};

__device__ __forceinline__ void wide_zero(Wide& t) {
#pragma unroll
  for (int i = 0; i < 17; i++) t.w[i] = 0u;
}

// t += s * v * 2^(32 i), i < 8: the even words' products (lo of v_j s at
// i + j, hi at i + j + 1 for even j) in one chain, the odd words' in
// another, each carry rippled to the top word. t + s v 2^(32 i) must stay
// below 2^544.
__device__ __forceinline__ void wide_row(Wide& t, const uint32_t* v,
                                         uint32_t s, int i) {
  t.w[i] = ptx::mad_lo_cc(v[0], s, t.w[i]);
  t.w[i + 1] = ptx::madc_hi_cc(v[0], s, t.w[i + 1]);
#pragma unroll
  for (int j = 2; j < 8; j += 2) {
    t.w[i + j] = ptx::madc_lo_cc(v[j], s, t.w[i + j]);
    t.w[i + j + 1] = ptx::madc_hi_cc(v[j], s, t.w[i + j + 1]);
  }
#pragma unroll
  for (int k = i + 8; k < 16; k++) t.w[k] = ptx::addc_cc(t.w[k], 0u);
  t.w[16] = ptx::addc(t.w[16], 0u);
  t.w[i + 1] = ptx::mad_lo_cc(v[1], s, t.w[i + 1]);
  t.w[i + 2] = ptx::madc_hi_cc(v[1], s, t.w[i + 2]);
#pragma unroll
  for (int j = 3; j < 8; j += 2) {
    t.w[i + j] = ptx::madc_lo_cc(v[j], s, t.w[i + j]);
    t.w[i + j + 1] = ptx::madc_hi_cc(v[j], s, t.w[i + j + 1]);
  }
#pragma unroll
  for (int k = i + 9; k < 16; k++) t.w[k] = ptx::addc_cc(t.w[k], 0u);
  t.w[16] = ptx::addc(t.w[16], 0u);
}

// t += a * b (schoolbook by rows of b's words)
__device__ __forceinline__ void wide_mac(Wide& t, const Fe& a, const Fe& b) {
#pragma unroll
  for (int i = 0; i < 8; i++) wide_row(t, a.w, b.w[i], i);
}

// Montgomery REDC: t * 2^-256 mod p. The result before subtraction is
// below t/2^256 + p, so for t < nsub * 2^256 * p it is below (nsub + 1) p
// and nsub conditional subtracts make it canonical.
template <int F>
__device__ __forceinline__ Fe redc(Wide& t, int nsub) {
  Fe p;
#pragma unroll
  for (int j = 0; j < 8; j++) p.w[j] = kP[F][j];
#pragma unroll
  for (int i = 0; i < 8; i++) wide_row(t, p.w, t.w[i] * kPinv[F], i);
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; j++) r.w[j] = t.w[8 + j];
  for (int s = 0; s < nsub; s++) cond_sub_p<F>(r);
  return r;
}

// One reduction step of the product below: m = L0 (-p^-1) mod 2^32, then
// (L, H) += m p with p's even words into L and its odd words into H. L[0]
// becomes 0. H's top carry is provably 0 (see mont_mul), so its chain ends
// without one; L's carry lands in H[7], the same position.
template <int F>
__device__ __forceinline__ void mont_reduce_step(uint32_t* L, uint32_t* H) {
  const uint32_t m = L[0] * kPinv[F];
  H[0] = ptx::mad_lo_cc(kP[F][1], m, H[0]);
  H[1] = ptx::madc_hi_cc(kP[F][1], m, H[1]);
#pragma unroll
  for (int j = 2; j < 6; j += 2) {
    H[j] = ptx::madc_lo_cc(kP[F][j + 1], m, H[j]);
    H[j + 1] = ptx::madc_hi_cc(kP[F][j + 1], m, H[j + 1]);
  }
  H[6] = ptx::madc_lo_cc(kP[F][7], m, H[6]);
  H[7] = ptx::madc_hi(kP[F][7], m, H[7]);
  L[0] = ptx::mad_lo_cc(kP[F][0], m, L[0]);
  L[1] = ptx::madc_hi_cc(kP[F][0], m, L[1]);
#pragma unroll
  for (int j = 2; j < 8; j += 2) {
    L[j] = ptx::madc_lo_cc(kP[F][j], m, L[j]);
    L[j + 1] = ptx::madc_hi_cc(kP[F][j], m, L[j + 1]);
  }
  H[7] = ptx::addc(H[7], 0u);
}

// a * b * 2^-256 mod p, canonical. b must be canonical; a may be any value
// below 2^256.
//
// CIOS (coarsely integrated operand scanning), one word of a a round: T <-
// (T + a_i b + m p) / 2^32. The running T is held as L + 2^32 H, two 8-word
// accumulators: L at word positions 0..7 takes the products of b's and p's
// even words, H at positions 1..8 those of the odd words, so each round's
// two multiply-add chains write disjoint registers and do not wait on each
// other's carries. The shift by one word renames H as the next L and moves
// L[1] into its bottom word and L[2..7] into the next H.
// Bounds: with a_i the round's multiplier and b < p, T < 2p after every
// round (T_i < (2p + 2^32 p + 2^32 p) / 2^32 = 2p, by induction), so a
// round's sum T + a_i b + m p stays below 2^288 and H's 8 words never carry
// out; the result is below 2p and one branch-free conditional subtract
// makes it canonical. (Running the rounds over b's words would let T reach
// a + p, past 2^256, for an unreduced a.)
template <int F>
__device__ __forceinline__ Fe mont_mul(const Fe& a, const Fe& b) {
  uint32_t L[8], H[8];
  uint32_t s = a.w[0];
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    L[j] = b.w[j] * s;
    L[j + 1] = __umulhi(b.w[j], s);
    H[j] = b.w[j + 1] * s;
    H[j + 1] = __umulhi(b.w[j + 1], s);
  }
  mont_reduce_step<F>(L, H);
#pragma unroll
  for (int i = 1; i < 8; i++) {
    s = a.w[i];
    uint32_t nL[8], nH[8];
    // the shift, with b's odd words' products into the new H
#pragma unroll
    for (int j = 0; j < 8; j++) nL[j] = H[j];
    nL[0] = ptx::add_cc(nL[0], L[1]);
#pragma unroll
    for (int j = 0; j < 6; j += 2) {
      nH[j] = ptx::madc_lo_cc(b.w[j + 1], s, L[j + 2]);
      nH[j + 1] = ptx::madc_hi_cc(b.w[j + 1], s, L[j + 3]);
    }
    nH[6] = ptx::madc_lo_cc(b.w[7], s, 0u);
    nH[7] = ptx::madc_hi(b.w[7], s, 0u);
    // b's even words' products into the new L; its carry to nH[7]
    nL[0] = ptx::mad_lo_cc(b.w[0], s, nL[0]);
    nL[1] = ptx::madc_hi_cc(b.w[0], s, nL[1]);
#pragma unroll
    for (int j = 2; j < 8; j += 2) {
      nL[j] = ptx::madc_lo_cc(b.w[j], s, nL[j]);
      nL[j + 1] = ptx::madc_hi_cc(b.w[j], s, nL[j + 1]);
    }
    nH[7] = ptx::addc(nH[7], 0u);
    mont_reduce_step<F>(nL, nH);
#pragma unroll
    for (int j = 0; j < 8; j++) {
      L[j] = nL[j];
      H[j] = nH[j];
    }
  }
  // the last shift: T = H + (L >> 32)
  Fe r;
  r.w[0] = ptx::add_cc(H[0], L[1]);
#pragma unroll
  for (int j = 1; j < 7; j++) r.w[j] = ptx::addc_cc(H[j], L[j + 1]);
  r.w[7] = ptx::addc(H[7], 0u);
  cond_sub_p<F>(r);
  return r;
}

// a^e (Montgomery in/out), e standard-form words, MSB-first square-and-
// multiply over the low `nbits` bits. e is uniform across a launch.
template <int F>
__device__ __forceinline__ Fe mont_pow(const Fe& a, const uint32_t* e,
                                       int nbits) {
  Fe acc = fe_one<F>();
  for (int i = nbits - 1; i >= 0; i--) {
    acc = mont_mul<F>(acc, acc);
    if ((e[i >> 5] >> (i & 31)) & 1u) acc = mont_mul<F>(acc, a);
  }
  return acc;
}

}  // namespace h2t
