// BN254 G1 complete additions on Montgomery Fq words (csrc/field.cuh).
//
// Shared by curve.cu (the batched complete add) and msm.cu (bucket
// accumulate and reduce), so both evaluate one formula, word for word.
// Renes-Costello-Batina 2015 for a = 0, b3 = 9: Algorithm 7 (projective +
// projective, complete) and Algorithm 8 (projective + affine, complete for
// q != infinity). A point is (X : Y : Z); the identity is (0 : 1 : 0).
#pragma once

#include "field.cuh"

namespace h2t {

struct Pt {
  Fe x, y, z;
};

__device__ __forceinline__ Fe mul9(const Fe& x) {
  Fe x2 = mod_add<kFq>(x, x);
  Fe x4 = mod_add<kFq>(x2, x2);
  Fe x8 = mod_add<kFq>(x4, x4);
  return mod_add<kFq>(x8, x);
}

// RCB15 Algorithm 8 (a = 0, b3 = 9): (X1:Y1:Z1) + (x2, y2), q != infinity.
__device__ __forceinline__ Pt mixed_add(const Pt& p, const Fe& x2,
                                        const Fe& y2) {
  Fe t0 = mont_mul<kFq>(p.x, x2);
  Fe t1 = mont_mul<kFq>(p.y, y2);
  Fe t3 = mod_add<kFq>(x2, y2);
  Fe t4 = mod_add<kFq>(p.x, p.y);
  t3 = mont_mul<kFq>(t3, t4);
  t4 = mod_add<kFq>(t0, t1);
  t3 = mod_sub<kFq>(t3, t4);
  t4 = mont_mul<kFq>(y2, p.z);
  t4 = mod_add<kFq>(t4, p.y);
  Fe y3 = mont_mul<kFq>(x2, p.z);
  y3 = mod_add<kFq>(y3, p.x);
  Fe x3 = mod_add<kFq>(t0, t0);
  t0 = mod_add<kFq>(x3, t0);
  Fe t2 = mul9(p.z);
  Fe z3 = mod_add<kFq>(t1, t2);
  t1 = mod_sub<kFq>(t1, t2);
  y3 = mul9(y3);
  x3 = mont_mul<kFq>(t4, y3);
  t2 = mont_mul<kFq>(t3, t1);
  x3 = mod_sub<kFq>(t2, x3);
  y3 = mont_mul<kFq>(y3, t0);
  Fe t1m = mont_mul<kFq>(t1, z3);
  y3 = mod_add<kFq>(t1m, y3);
  t0 = mont_mul<kFq>(t0, t3);
  z3 = mont_mul<kFq>(z3, t4);
  z3 = mod_add<kFq>(z3, t0);
  return Pt{x3, y3, z3};
}

// RCB15 Algorithm 7 (a = 0, b3 = 9): complete projective addition.
__device__ __forceinline__ Pt full_add(const Pt& p, const Pt& q) {
  Fe t0 = mont_mul<kFq>(p.x, q.x);
  Fe t1 = mont_mul<kFq>(p.y, q.y);
  Fe t2 = mont_mul<kFq>(p.z, q.z);
  Fe t3 = mod_add<kFq>(p.x, p.y);
  Fe t4 = mod_add<kFq>(q.x, q.y);
  t3 = mont_mul<kFq>(t3, t4);
  t4 = mod_add<kFq>(t0, t1);
  t3 = mod_sub<kFq>(t3, t4);
  t4 = mod_add<kFq>(p.y, p.z);
  Fe x3 = mod_add<kFq>(q.y, q.z);
  t4 = mont_mul<kFq>(t4, x3);
  x3 = mod_add<kFq>(t1, t2);
  t4 = mod_sub<kFq>(t4, x3);
  x3 = mod_add<kFq>(p.x, p.z);
  Fe y3 = mod_add<kFq>(q.x, q.z);
  x3 = mont_mul<kFq>(x3, y3);
  y3 = mod_add<kFq>(t0, t2);
  y3 = mod_sub<kFq>(x3, y3);
  x3 = mod_add<kFq>(t0, t0);
  t0 = mod_add<kFq>(x3, t0);
  t2 = mul9(t2);
  Fe z3 = mod_add<kFq>(t1, t2);
  t1 = mod_sub<kFq>(t1, t2);
  y3 = mul9(y3);
  x3 = mont_mul<kFq>(t4, y3);
  t2 = mont_mul<kFq>(t3, t1);
  x3 = mod_sub<kFq>(t2, x3);
  y3 = mont_mul<kFq>(y3, t0);
  t1 = mont_mul<kFq>(t1, z3);
  y3 = mod_add<kFq>(t1, y3);
  t0 = mont_mul<kFq>(t0, t3);
  z3 = mont_mul<kFq>(z3, t4);
  z3 = mod_add<kFq>(z3, t0);
  return Pt{x3, y3, z3};
}

__device__ __forceinline__ Pt identity() {
  return Pt{fe_zero(), fe_one<kFq>(), fe_zero()};
}

__device__ __forceinline__ Pt pt_load(const uint32_t* src) {
  return Pt{fe_load(src), fe_load(src + 8), fe_load(src + 16)};
}

__device__ __forceinline__ void pt_store(uint32_t* dst, const Pt& p) {
  fe_store(dst, p.x);
  fe_store(dst + 8, p.y);
  fe_store(dst + 16, p.z);
}

}  // namespace h2t
